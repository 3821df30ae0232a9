"""Plain PyTorch versions of the chunked Mamba2 SSD scan.

`ssd_chunked` is the oracle `ssd_ref` (src/repro/kernels/mamba2_ssd/ref.py):
like it, it delegates to the model's chunk step (`models.mamba2._ssd_chunk`)
scanned over the chunks.  It is the path tensors on the CPU take and what
the CUDA forward kernel is held against on the card.  `ssd_chunked_bwd` is
its gradient written out chunk by chunk: the CPU path's backward, and what
the CUDA backward kernel is held against beside autograd through
`ssd_chunked`.  `ssd_chunked_staged` computes `ssd_chunked`'s Y and final
state in the three stages the CUDA forward runs (`ssd_fwd_chunk_state`,
`ssd_fwd_state_pass`, `ssd_fwd_chunk_out`), and `ssd_chunked_bwd_staged`
the gradient in the three stages the CUDA backward runs
(`ssd_bwd_chunk_state`, `ssd_bwd_state_pass`, `ssd_bwd_chunk_grads`): the
plain version of each stage; the backward's first two stages are the
forward's with the cotangent's half added, as in the kernels.
`ssd_sequential` is the step-by-step recurrence (`ssd_sequential_ref`), an
independent formulation for cross-checks.

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


def ssd_chunked_bwd(xdt, dA, B_, C_, dY, *, chunk: int):
    """The gradient of `ssd_chunked`'s Y (zero initial state) with cotangent
    dY (B,S,H,hd).  Returns (dxdt, ddA, dB, dC) in the inputs' shapes and
    dtypes, computed in fp32 (fp64 for fp64 inputs).

    Per chunk, with cum the in-chunk cumsum of dA, E[t] = exp(cum[t]),
    D[j] = exp(cum[Q-1] - cum[j]), L[t][j] = exp(cum[t] - cum[j]) for j <= t
    (else 0), G = C.B^T, M = G o L, S_in the state entering the chunk, and
    dS the cotangent of the state leaving it (0 after the last chunk):
      dM  = dY.x^T on j <= t;  dG = dM o L
      dx  = M^T.dY + D o (dS.B)            per row j: D[j] dS B[j]
      dC  = dG.B + E o (dY.S_in)
      dB  = dG^T.C + D o (x.dS)            summed over the group's heads
      dcum = rowsum(dM o M) - colsum(dM o M) + E o (C . dY.S_in)
             - R, R[j] = D[j] x[j].(dS B[j]); dcum[Q-1] += E[Q-1] <dS, S_in>
             + sum_j R[j]  (the terms that cancel exactly are left out)
      ddA = the reverse in-chunk cumsum of dcum
      dS <- E[Q-1] dS + sum_t E[t] dY[t]^T C[t]   (for the chunk before)
    The states S_in come from a forward walk over the chunks first."""
    ct = torch.promote_types(xdt.dtype, torch.float32)
    dtypes = [t.dtype for t in (xdt, dA, B_, C_)]
    Bb, S, H, hd = xdt.shape
    G, N = B_.shape[2], B_.shape[3]
    Hg = H // G
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd: S={S} is not a multiple of the chunk {Q}")
    nC = S // Q
    x = xdt.to(ct).reshape(Bb, nC, Q, G, Hg, hd)
    dy = dY.to(ct).reshape(Bb, nC, Q, G, Hg, hd)
    Bc = B_.to(ct).reshape(Bb, nC, Q, G, N)
    Cc = C_.to(ct).reshape(Bb, nC, Q, G, N)
    cum = torch.cumsum(dA.to(ct).reshape(Bb, nC, Q, G, Hg), dim=2)
    E = torch.exp(cum)
    D = torch.exp(cum[:, :, -1:] - cum)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    mask5 = mask[None, :, :, None, None]
    strict = mask5 & ~torch.eye(Q, dtype=torch.bool, device=x.device)[
        None, :, :, None, None]

    states, s = [], torch.zeros((Bb, G, Hg, hd, N), dtype=ct, device=x.device)
    for c in range(nC):
        states.append(s)
        s = s * E[:, c, -1][..., None, None] + torch.einsum(
            "bjgh,bjghd,bjgn->bghdn", D[:, c], x[:, c], Bc[:, c])

    dS = torch.zeros_like(s)
    outs = []
    for c in reversed(range(nC)):
        xc, dyc, bc, cc, sin = x[:, c], dy[:, c], Bc[:, c], Cc[:, c], states[c]
        ec, dc, cumc = E[:, c], D[:, c], cum[:, c]
        L = torch.exp(torch.where(
            mask5, cumc[:, :, None] - cumc[:, None], -1e9))    # (B,Q,Q,G,Hg)
        M = L * torch.einsum("bign,bjgn->bijg", cc, bc)[..., None]
        dM = torch.einsum("bighd,bjghd->bijgh", dyc, xc) * mask5
        dG = dM * L
        dSB = torch.einsum("bghdn,bjgn->bjghd", dS, bc)
        dx = torch.einsum("bijgh,bighd->bjghd", M, dyc) + dc[..., None] * dSB
        dyS = torch.einsum("bighd,bghdn->bighn", dyc, sin)
        dC = torch.einsum("bijgh,bjgn->bign", dG, bc) + torch.einsum(
            "bigh,bighn->bign", ec, dyS)
        dB = torch.einsum("bijgh,bign->bjgn", dG, cc) + torch.einsum(
            "bjgh,bjghd,bghdn->bjgn", dc, xc, dS)
        # the diagonal of dM o M and R[Q-1] (D[Q-1] = 1) enter dcum once
        # with each sign; they are left out, exactly, rather than summed and
        # cancelled in rounding
        P = dM * M * strict
        R = dc[:, :-1] * (xc[:, :-1] * dSB[:, :-1]).sum(-1)
        dcum = (P.sum(2) - P.sum(1)
                + ec * torch.einsum("bign,bighn->bigh", cc, dyS))
        dcum[:, :-1] -= R
        dcum[:, -1] += ec[:, -1] * (dS * sin).sum((-2, -1)) + R.sum(1)
        ddA = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        dS = dS * ec[:, -1][..., None, None] + torch.einsum(
            "bigh,bighd,bign->bghdn", ec, dyc, cc)
        outs.append((dx, ddA, dB, dC))
    dx, ddA, dB, dC = (torch.cat(o[::-1], dim=1) for o in zip(*outs))
    return (dx.reshape(Bb, S, H, hd).to(dtypes[0]),
            ddA.reshape(Bb, S, H).to(dtypes[1]),
            dB.to(dtypes[2]), dC.to(dtypes[3]))


def _matmul(a, b, name):
    return torch.matmul(a, b)


def _chunked(xdt, dA, B_, C_, dY, chunk):
    """The inputs cut into chunks, in fp32 (fp64 for fp64 inputs), laid out
    (B, G, Hg, nC, Q, .) so that a chunk's products are batched matmuls:
    x, dy (B,G,Hg,nC,Q,hd) (dy None where dY is); Bc, Cc (B,G,1,nC,Q,N);
    cum, E = exp(cum) and D = exp(cum[Q-1] - cum) (B,G,Hg,nC,Q)."""
    ct = torch.promote_types(xdt.dtype, torch.float32)
    Bb, S, H, hd = xdt.shape
    G, N = B_.shape[2], B_.shape[3]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd: S={S} is not a multiple of the chunk {Q}")
    nC = S // Q

    def heads(t, w):   # (B, S, H, w) -> (B, G, Hg, nC, Q, w)
        return t.to(ct).reshape(Bb, nC, Q, G, H // G, w).permute(
            0, 3, 4, 1, 2, 5)

    x = heads(xdt, hd)
    dy = None if dY is None else heads(dY, hd)
    Bc, Cc = (t.to(ct).reshape(Bb, nC, Q, G, 1, N).permute(0, 3, 4, 1, 2, 5)
              for t in (B_, C_))
    cum = torch.cumsum(heads(dA[..., None], 1)[..., 0], dim=-1)
    E = torch.exp(cum)
    D = torch.exp(cum[..., -1:] - cum)
    return x, dy, Bc, Cc, cum, E, D


def _back(t):
    """(B, G, h, nC, Q, w) -> (B, S, G * h, w)"""
    Bb, nC, Q = t.shape[0], t.shape[3], t.shape[4]
    return t.permute(0, 3, 4, 1, 2, 5).reshape(Bb, nC * Q, -1, t.shape[-1])


def _walk(terms, a, s, reverse=False):
    """Stage 2's one walk over the chunks, elementwise over (hd, N): the
    value entering chunk c is s, then s <- a_c s + terms[c]; chunks in
    order, or from the last back.  terms (B,H,nC,hd,N), a (B,H,nC), s
    (B,H,hd,N).  Returns (the value entering each chunk (B,H,nC,hd,N), the
    value after the walk's last chunk)."""
    out = torch.empty_like(terms)
    chunks = range(a.shape[-1])
    for c in (reversed(chunks) if reverse else chunks):
        out[:, :, c] = s
        s = a[:, :, c, None, None] * s + terms[:, :, c]
    return out, s


def ssd_fwd_chunk_state(xdt, dA, B_, C_, *, chunk: int, mm=None):
    """Stage 1 of the staged forward, every chunk at once: chunk c's own
    term of the state leaving it, x^T.(D o B) (hd x N, depth Q), and its
    decay a_c = E[Q-1] = exp(cum[Q-1]).  Returns the term as (B,H,nC,hd,N)
    and a (B,H,nC).  `mm(a, b, name)` computes each product (default
    torch.matmul; the name says which)."""
    mm = mm or _matmul
    x, _, Bc, _, _, E, D = _chunked(xdt, dA, B_, C_, None, chunk)
    Bb, G, Hg, nC, Q, hd = x.shape
    N = Bc.shape[-1]
    ds = mm(x.mT, D[..., None] * Bc, "x^T.(D o B)")
    return (ds.reshape(Bb, G * Hg, nC, hd, N),
            E[..., -1].reshape(Bb, G * Hg, nC))


def ssd_fwd_state_pass(ds, a, initial_state=None):
    """Stage 2 of the staged forward, the one scan over the chunks:
    S_in[0] = initial_state (or 0), S_in[c+1] = a_c S_in[c] + ds[c].  ds
    (B,H,nC,hd,N) and a (B,H,nC) from stage 1, initial_state (B,H,hd,N).
    Returns (S_in (B,H,nC,hd,N), the final state (B,H,hd,N))."""
    s0 = (torch.zeros_like(ds[:, :, 0]) if initial_state is None
          else initial_state.to(ds.dtype))
    return _walk(ds, a, s0)


def ssd_fwd_chunk_out(xdt, dA, B_, C_, s_in, *, chunk: int, mm=None):
    """Stage 3 of the staged forward, every chunk at once given the state
    S_in entering it ((B,H,nC,hd,N), from stage 2): Y = M.x + E o
    (C.S_in^T), M = (C.B^T) o L.  Returns Y (B,S,H,hd) in fp32 (fp64 for
    fp64 inputs); `mm` as in `ssd_fwd_chunk_state`."""
    mm = mm or _matmul
    x, _, Bc, Cc, cum, E, _ = _chunked(xdt, dA, B_, C_, None, chunk)
    Bb, G, Hg, nC, Q, hd = x.shape
    N = Bc.shape[-1]
    s_in = s_in.to(x.dtype).reshape(Bb, G, Hg, nC, hd, N)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(mask, cum[..., :, None] - cum[..., None, :],
                              -1e9))
    M = mm(Cc, Bc.mT, "C.B^T") * L
    y = mm(M, x, "M.x") + E[..., None] * mm(Cc, s_in.mT, "C.S_in^T")
    return _back(y)


def ssd_chunked_staged(xdt, dA, B_, C_, *, chunk: int, initial_state=None,
                       mm=None):
    """`ssd_chunked`'s (Y, final_state) through the three stages of the
    CUDA forward: stage 1 (chunk-parallel), stage 2 (the scan over the
    chunks, from initial_state or 0), stage 3 (chunk-parallel).  `mm` as in
    `ssd_fwd_chunk_state`."""
    ds, a = ssd_fwd_chunk_state(xdt, dA, B_, C_, chunk=chunk, mm=mm)
    s_in, final = ssd_fwd_state_pass(ds, a, initial_state)
    return ssd_fwd_chunk_out(xdt, dA, B_, C_, s_in, chunk=chunk, mm=mm), final


def ssd_bwd_chunk_state(xdt, dA, B_, C_, dY, *, chunk: int, mm=None):
    """Stage 1 of the staged backward, every chunk at once: the forward's
    stage 1 (chunk c's term of the state leaving it, x^T.(D o B), and a_c),
    and chunk c's own term of the cotangent of the state entering it,
    dY^T.(E o C) (hd x N, depth Q).  Returns the two terms as
    (B,H,nC,hd,N) and a (B,H,nC); `mm` as in `ssd_fwd_chunk_state`."""
    ds, a = ssd_fwd_chunk_state(xdt, dA, B_, C_, chunk=chunk, mm=mm)
    mm = mm or _matmul
    _, dy, _, Cc, _, E, _ = _chunked(xdt, dA, B_, C_, dY, chunk)
    dds = mm(dy.mT, E[..., None] * Cc, "dY^T.(E o C)")
    return ds, dds.reshape(ds.shape), a


def ssd_bwd_state_pass(ds, dds, a):
    """Stage 2 of the staged backward, the forward's walk from 0 and a walk
    from the last chunk back: S_in[0] = 0, S_in[c+1] = a_c S_in[c] + ds[c]
    (the state entering c), and dS[nC-1] = 0, dS[c-1] = a_c dS[c] + dds[c]
    (the cotangent of the state leaving c).  ds, dds (B,H,nC,hd,N) and a
    (B,H,nC) from stage 1.  Returns (S_in, dS), each (B,H,nC,hd,N)."""
    s_in, _ = ssd_fwd_state_pass(ds, a)
    d_s, _ = _walk(dds, a, torch.zeros_like(dds[:, :, 0]), reverse=True)
    return s_in, d_s


def ssd_bwd_chunk_grads(xdt, dA, B_, C_, dY, s_in, d_s, *, chunk: int,
                        mm=None):
    """Stage 3, every chunk at once given the state S_in entering it and the
    cotangent dS of the state leaving it ((B,H,nC,hd,N) each, from stage 2):
    the terms of `ssd_chunked_bwd`.  Returns (dxdt, ddA, dB, dC) as that
    does; `mm` as in `ssd_bwd_chunk_state`."""
    mm = mm or _matmul
    dtypes = [t.dtype for t in (xdt, dA, B_, C_)]
    x, dy, Bc, Cc, cum, E, D = _chunked(xdt, dA, B_, C_, dY, chunk)
    Bb, G, Hg, nC, Q, hd = x.shape
    N = Bc.shape[-1]
    s_in, d_s = (t.to(x.dtype).reshape(Bb, G, Hg, nC, hd, N)
                 for t in (s_in, d_s))
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    strict = mask & ~torch.eye(Q, dtype=torch.bool, device=x.device)
    L = torch.exp(torch.where(mask, cum[..., :, None] - cum[..., None, :],
                              -1e9))
    M = mm(Cc, Bc.mT, "C.B^T") * L
    dM = mm(dy, x.mT, "dY.x^T") * mask
    dG = dM * L
    dSB = mm(Bc, d_s.mT, "B.dS^T")
    dx = mm(M.mT, dy, "M^T.dY") + D[..., None] * dSB
    dyS = mm(dy, s_in, "dY.S_in")
    dC = mm(dG, Bc, "dG.B") + E[..., None] * dyS
    dB = mm(dG.mT, Cc, "dG^T.C") + D[..., None] * mm(x, d_s, "x.dS")
    # the diagonal of dM o M and R[Q-1] (D[Q-1] = 1) are left out exactly,
    # as in ssd_chunked_bwd
    P = dM * M * strict
    R = D[..., :-1] * (x[..., :-1, :] * dSB[..., :-1, :]).sum(-1)
    dcum = P.sum(-1) - P.sum(-2) + E * (Cc * dyS).sum(-1)
    dcum[..., :-1] -= R
    dcum[..., -1] += E[..., -1] * (d_s * s_in).sum((-2, -1)) + R.sum(-1)
    ddA = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])

    return (_back(dx).to(dtypes[0]),
            _back(ddA[..., None])[..., 0].to(dtypes[1]),
            _back(dB.sum(2, keepdim=True)).to(dtypes[2]),
            _back(dC.sum(2, keepdim=True)).to(dtypes[3]))


def ssd_chunked_bwd_staged(xdt, dA, B_, C_, dY, *, chunk: int, mm=None):
    """`ssd_chunked_bwd`'s gradient through the three stages of the CUDA
    backward: stage 1 (chunk-parallel), stage 2 (the scan over the chunks),
    stage 3 (chunk-parallel).  `mm` as in `ssd_bwd_chunk_state`."""
    ds, dds, a = ssd_bwd_chunk_state(xdt, dA, B_, C_, dY, chunk=chunk, mm=mm)
    s_in, d_s = ssd_bwd_state_pass(ds, dds, a)
    return ssd_bwd_chunk_grads(xdt, dA, B_, C_, dY, s_in, d_s, chunk=chunk,
                               mm=mm)


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
