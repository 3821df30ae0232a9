"""Plain PyTorch versions of the chunked Mamba2 SSD scan.

`ssd_chunked` is the oracle `ssd_ref` (src/repro/kernels/mamba2_ssd/ref.py):
like it, it delegates to the model's chunk step (`models.mamba2._ssd_chunk`)
scanned over the chunks.  It is the path tensors on the CPU take, what the
CUDA kernel is held against on the card, and the function whose autograd is
the kernel's backward.  `ssd_sequential` is the step-by-step recurrence
(`ssd_sequential_ref`), an independent formulation for cross-checks.

The model module is imported as a module, not by name: models.mamba2
imports the op, the op imports this file, and this file reaches back for
the chunk step only when called.
"""
from __future__ import annotations

import torch

from repro_torch.models import mamba2


def ssd_chunked(xdt, dA, B_, C_, *, chunk: int, initial_state=None):
    """xdt (B,S,H,hd) [= dt*x]; dA (B,S,H); B_/C_ (B,S,G,N); initial_state
    (B,H,hd,N) or None (zeros).  Chunks of min(chunk, S) steps, which must
    divide S.  Computed in fp32 (fp64 for fp64 inputs).  Returns
    (Y (B,S,H,hd), final_state (B,H,hd,N))."""
    ct = torch.promote_types(xdt.dtype, torch.float32)
    xdt, dA, B_, C_ = (t.to(ct) for t in (xdt, dA, B_, C_))
    Bb, S, H, hd = xdt.shape
    G, N = B_.shape[2], B_.shape[3]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd: S={S} is not a multiple of the chunk {Q}")
    nC = S // Q
    cum = torch.cumsum(dA.reshape(Bb, nC, Q, H), dim=2)
    state = (torch.zeros((Bb, H, hd, N), dtype=ct, device=xdt.device)
             if initial_state is None else initial_state.to(ct))
    ys = []
    for c in range(nC):
        t = slice(c * Q, (c + 1) * Q)
        state, y = mamba2._ssd_chunk(
            state, (cum[:, c], B_[:, t], C_[:, t], xdt[:, t]),
            H=H, G=G, N=N, hd=hd)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def ssd_sequential(xdt, dA, B_, C_):
    """Step recurrence from a zero state: S_t = exp(dA_t) S_{t-1} +
    xdt_t B_t^T, y_t = S_t C_t.  Returns (Y, final_state)."""
    Bb, S, H, hd = xdt.shape
    G, N = B_.shape[2], B_.shape[3]
    Hg = H // G
    state = torch.zeros((Bb, G, Hg, hd, N), dtype=torch.float32,
                        device=xdt.device)
    ys = []
    for t in range(S):
        x = xdt[:, t].reshape(Bb, G, Hg, hd)
        a = torch.exp(dA[:, t]).reshape(Bb, G, Hg)
        state = state * a[..., None, None] + torch.einsum(
            "bghd,bgn->bghdn", x, B_[:, t])
        ys.append(torch.einsum("bgn,bghdn->bghd", C_[:, t], state)
                  .reshape(Bb, H, hd))
    return torch.stack(ys, dim=1), state.reshape(Bb, H, hd, N)
