"""Plain PyTorch versions of the chunked RWKV6 WKV recurrence.

`wkv6_chunked` ports the JAX model's chunk step (src/repro/models/rwkv.py
`_wkv_chunk`, scanned by `time_mix`) and the JAX oracle `wkv6_ref`
(src/repro/kernels/rwkv6_scan/ref.py): the path tensors on the CPU take,
and what the CUDA kernels are held against on the card.
`wkv6_chunked_staged` computes the same function as the card does, in three
stages (`wkv6_chunk_state`, `wkv6_state_pass`, `wkv6_chunk_out`, one
function per CUDA kernel of csrc/wkv6.cu), so that each stage's result can
be held against the kernel's.  `wkv6_sequential` is the step-by-step
recurrence (`wkv6_sequential_ref`), an independent formulation for
cross-checks.

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
    decay, dS = chunk_state_term(cumw, k, v)
    return S0 * decay[..., None] + dS, chunk_y(S0, cumw, r, k, v, u)


def chunk_state_term(cumw, k, v):
    """The chunk's decay exp(cumw[Q-1]) (B,H,hd) and its own term of the
    state leaving it, sum_j (k[j] exp(cumw[Q-1] - cumw[j]))^T v[j]
    (B,H,hd,hd); arguments as `wkv_chunk` takes them."""
    dec_end = torch.exp(cumw[:, -1:] - cumw)                   # (B,Q,H,hd)
    return (torch.exp(cumw[:, -1]),
            torch.einsum("bjhk,bjhv->bhkv", k * dec_end, v))


def chunk_y(S0, cumw, r, k, v, u):
    """The chunk's y (B,Q,H,hd) given the state S0 entering it; arguments as
    `wkv_chunk` takes them."""
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
    return y + torch.einsum("bthk,bhkv->bthv", rd, S0)


def wkv6_chunked(r, k, v, logw, u, *, chunk: int, initial_state=None):
    """r/k/v/logw: (B, S, H, hd) fp32; u: (H, hd); initial_state
    (B, H, hd, hd) or None (zeros).  Chunks of min(chunk, S) steps, which
    must divide S.  Returns (y (B,S,H,hd), final_state (B,H,hd,hd))."""
    B, S, H, hd = r.shape
    Q = _chunk_of(S, chunk)
    cumw = torch.cumsum(logw.reshape(B, S // Q, Q, H, hd), dim=2)
    state = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
             if initial_state is None else initial_state)
    ys = []
    for c in range(S // Q):
        t = slice(c * Q, (c + 1) * Q)
        state, y = wkv_chunk(state, cumw[:, c], r[:, t], k[:, t], v[:, t], u)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def _folded(x, Q):
    """(B, S, H, hd) -> (B * S/Q, Q, H, hd): one row per (b, chunk)."""
    B, S, H, hd = x.shape
    return x.reshape(B * (S // Q), Q, H, hd)


def _chunk_of(S, chunk):
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"wkv6: S={S} is not a multiple of the chunk {Q}")
    return Q


def wkv6_chunk_state(k, v, logw, *, chunk: int):
    """Stage 1 of the staged version, every chunk at once: chunk c's own
    term of the state leaving it, dS_c (B,H,nC,hd,hd), and its decay
    a_c = exp(cumw[Q-1]) (B,H,nC,hd).  k, v, logw (B,S,H,hd)."""
    B, S, H, hd = k.shape
    Q = _chunk_of(S, chunk)
    cumw = torch.cumsum(_folded(logw, Q), dim=1)
    decay, dS = chunk_state_term(cumw, _folded(k, Q), _folded(v, Q))
    nC = S // Q
    return (dS.reshape(B, nC, H, hd, hd).transpose(1, 2).contiguous(),
            decay.reshape(B, nC, H, hd).transpose(1, 2).contiguous())


def wkv6_state_pass(dS, decay, initial_state=None):
    """Stage 2, the one scan over the chunks, elementwise over (hd, hd):
    S_in[0] = initial_state (or 0), S_in[c+1] = diag(a_c) S_in[c] + dS_c.
    dS (B,H,nC,hd,hd) and decay (B,H,nC,hd) from stage 1.  Returns (S_in
    (B,H,nC,hd,hd), the state entering each chunk; the final state)."""
    s = (torch.zeros_like(dS[:, :, 0]) if initial_state is None
         else initial_state)
    s_in = torch.empty_like(dS)
    for c in range(dS.shape[2]):
        s_in[:, :, c] = s
        s = s * decay[:, :, c, :, None] + dS[:, :, c]
    return s_in, s


def wkv6_chunk_out(r, k, v, logw, u, s_in, *, chunk: int):
    """Stage 3, every chunk at once given the state S_in entering it
    ((B,H,nC,hd,hd), from stage 2): y (B,S,H,hd)."""
    B, S, H, hd = r.shape
    Q = _chunk_of(S, chunk)
    cumw = torch.cumsum(_folded(logw, Q), dim=1)
    s0 = s_in.transpose(1, 2).reshape(B * (S // Q), H, hd, hd)
    y = chunk_y(s0, cumw, *(_folded(x, Q) for x in (r, k, v)), u)
    return y.reshape(B, S, H, hd)


def wkv6_chunked_staged(r, k, v, logw, u, *, chunk: int, initial_state=None):
    """`wkv6_chunked` in the card's three stages; the same arguments and
    results."""
    dS, decay = wkv6_chunk_state(k, v, logw, chunk=chunk)
    s_in, final = wkv6_state_pass(dS, decay, initial_state)
    return wkv6_chunk_out(r, k, v, logw, u, s_in, chunk=chunk), final


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
