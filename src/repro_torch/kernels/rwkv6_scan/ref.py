"""Plain PyTorch versions of the chunked RWKV6 WKV recurrence.

`wkv6_chunked` ports the JAX model's chunk step (src/repro/models/rwkv.py
`_wkv_chunk`, scanned by `time_mix`) and the JAX oracle `wkv6_ref`
(src/repro/kernels/rwkv6_scan/ref.py): the path tensors on the CPU take,
and what the CUDA kernel is held against on the card.  `wkv6_sequential`
is the step-by-step recurrence (`wkv6_sequential_ref`), an independent
formulation for cross-checks.

In JAX the oracle imports the model's chunk function.  Here the chunk math
lives in this module and models/rwkv.py reaches it through the op; the
other way round would make a circular import model -> ops -> ref -> model.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def wkv_chunk(S0, cumw, r, k, v, u):
    """One chunk.  S0 (B,H,hd,hd) fp32 (k-dim x v-dim); cumw (B,Q,H,hd) the
    inclusive cumsum of log-decay over the chunk; r, k, v (B,Q,H,hd);
    u (H,hd).  Returns (S1, y (B,Q,H,hd))."""
    Q = r.shape[1]
    # cum_excl[t] = cumw[t-1] (the previous step's cumw; 0 at t=0)
    cum_excl = F.pad(cumw[:, :-1], (0, 0, 0, 0, 1, 0))
    # intra-chunk: A[t,j] = sum_d r[t,d] k[j,d] exp(cum_excl[t,d]-cumw[j,d]),
    # j<t.  The mask goes inside the exponent: for j>=t the delta is
    # positive and exp overflows; masked terms are exactly 0.
    diff = cum_excl[:, :, None] - cumw[:, None, :]            # (B,Q,Q,H,hd)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=r.device).tril(-1)
    E = torch.exp(torch.where(mask[None, :, :, None, None], diff, -1e9))
    A = (r[:, :, None] * k[:, None] * E).sum(-1)               # (B,t,j,H)
    y = torch.einsum("btjh,bjhd->bthd", A, v)
    # bonus diagonal
    y = y + torch.einsum("bthd,bthd->bth", r, u[None, None] * k)[..., None] * v
    # inter-chunk from the carried state
    rd = r * torch.exp(cum_excl)
    y = y + torch.einsum("bthk,bhkv->bthv", rd, S0)
    # state update
    dec_end = torch.exp(cumw[:, -1:] - cumw)                   # (B,Q,H,hd)
    S1 = (S0 * torch.exp(cumw[:, -1])[..., None]
          + torch.einsum("bjhk,bjhv->bhkv", k * dec_end, v))
    return S1, y


def wkv6_chunked(r, k, v, logw, u, *, chunk: int, initial_state=None):
    """r/k/v/logw: (B, S, H, hd) fp32; u: (H, hd); initial_state
    (B, H, hd, hd) or None (zeros).  Chunks of min(chunk, S) steps, which
    must divide S.  Returns (y (B,S,H,hd), final_state (B,H,hd,hd))."""
    B, S, H, hd = r.shape
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"wkv6: S={S} is not a multiple of the chunk {Q}")
    cumw = torch.cumsum(logw.reshape(B, S // Q, Q, H, hd), dim=2)
    state = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
             if initial_state is None else initial_state)
    ys = []
    for c in range(S // Q):
        t = slice(c * Q, (c + 1) * Q)
        state, y = wkv_chunk(state, cumw[:, c], r[:, t], k[:, t], v[:, t], u)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def wkv6_sequential(r, k, v, logw, u):
    """Step-by-step recurrence from a zero state: y[t] = r[t] . (S + u (x)
    k[t] v[t]^T), S <- diag(exp(logw[t])) S + k[t] v[t]^T.
    Returns (y, final_state)."""
    B, S, H, hd = r.shape
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(S):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               state + u[None, ..., None] * kv))
        state = state * torch.exp(logw[:, t])[..., None] + kv
    return torch.stack(ys, dim=1), state
