"""The work of one kernel call, counted from its shapes: the FLOPs (and, for
the scans, the exps) the function needs and the bytes it must move, each
input read once and each output written once.  `chip_smoke.py` divides
these by the card's rates for its bound column; `launch.hlo_analysis` adds
them to its count, since a kernel launched through ctypes never reaches the
dispatcher.

While an analysis is active, a kernel op calls `kernel_call` once per call:
the call's count is recorded, and the aten ops run inside (the plain
version, on meta or on the CPU) are not counted, so a cell counts the same
whichever version ran.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple


class Cost(NamedTuple):
    flops: float      # every FLOP (for the scans: products and the rest)
    nbytes: float     # each input read once, each output written once
    exps: float = 0.0
    prod: float = 0.0  # the part of flops in matrix products (the SSD's)


def flash_attention(b, s, hq, g, hd, *, window=None, itemsize, hd_v=None,
                    t=None, causal=True) -> Cost:
    """Allowed (q, k) pairs x 2*(hd + hd_v) FLOPs (Q.K^T at the q/k head
    dim hd, P.V at the v head dim hd_v, default hd), and q, k, v read once
    plus o written once.  s queries against t keys (default s); query i
    sees key j < t where (not causal or j <= i) and (no window or
    i - j < window)."""
    hd_v = hd if hd_v is None else hd_v
    t = s if t is None else t
    pairs = b * hq * _pairs(s, t, window, causal)
    flops = 2.0 * (hd + hd_v) * pairs
    nbytes = itemsize * (b * s * hq * (hd + hd_v) + b * t * g * (hd + hd_v))
    return Cost(flops, nbytes)


def decode_attention(b, t, hq, g, hd, *, itemsize, window=None) -> Cost:
    """One new token a batch row against a cache of t keys: 2*hd FLOPs for
    q.k and 2*hd for p.v per (head, key), over t keys a row (the window's,
    if smaller: the positions lie on the card, so every row counts its
    whole reach); q read once, K and V (b, keys, g, hd) once, o written
    once."""
    keys = min(t, window) if window else t
    flops = 4.0 * hd * b * hq * keys
    nbytes = itemsize * (2 * b * keys * g * hd + 2 * b * hq * hd)
    return Cost(flops, nbytes)


def _pairs(s, t, window, causal) -> int:
    """Sum over queries i < s of the keys j < t with (not causal or
    j <= i) and (no window or i - j < window), in closed form."""
    def upto(n):              # sum_{i < n} (min(i, t-1) + 1), causal keys
        full = min(n, t)
        return full * (full + 1) // 2 + max(0, n - t) * t

    def lo_sum(n):            # sum_{i < n} max(0, i - window + 1)
        m = max(0, n - window)
        return m * (m + 1) // 2

    if not causal:
        hi = s * t
        if not window:
            return hi
        return sum(max(0, t - max(0, i - window + 1)) for i in range(s))
    if not window:
        return upto(s)
    # causal and windowed: keys max(0, i-w+1) .. min(i, t-1)
    return sum(max(0, min(i, t - 1) - max(0, i - window + 1) + 1)
               for i in range(s)) if t < s else upto(s) - lo_sum(s)


def wkv6(b, s, h, hd, q, with_state) -> Cost:
    """The chunked WKV, from counts per chunk and (b, h): exps
    (intra-chunk pairs j < t over hd; r and k rescaled; the chunk's decay)
    and fp32 FLOPs (cumsum, the intra-chunk products, A.v, the bonus, r.S,
    the state update); r, k, v, logw, u and the initial state read once, y
    and the final state written once."""
    pairs, n = q * (q - 1) // 2, (s // q) * b * h
    exps = n * (pairs * hd + (q - 1) * hd + q * hd + hd)
    flops = n * (q * hd + pairs * hd * 4 + pairs * hd * 2 + q * hd * 5
                 + (q - 1) * hd + q * hd * 2 + q * hd * hd * 2
                 + hd * hd * 2 + q * hd * hd * 2)
    nbytes = 4 * (5 * b * s * h * hd + h * hd
                  + (2 if with_state else 1) * b * h * hd * hd)
    return Cost(flops, nbytes, exps)


def ssd(b, s, h, hd, n, q, itemsize=4, with_state=False,
        final_state=False) -> Cost:
    """The chunked SSD forward: C.B^T over the lower triangle j <= t once
    per (b, chunk), since with one group B and C are shared by every head;
    per (b, h, chunk) the cumsum, the decay exps and M over j <= t, M.x,
    C.S and its scaling, the state update.  x, dA, B and C (and the
    initial state, `with_state`) read once, Y written once (and the final
    state: `with_state` or `final_state`).  `prod` is the part in matrix
    products (C.B^T, M.x, C.S, the state update)."""
    pairs, chunks = q * (q + 1) // 2, (s // q) * b
    nblk = chunks * h
    exps = nblk * (pairs + 2 * q)
    prod = chunks * pairs * n * 2 + nblk * (
        pairs * hd * 2 + q * n * hd * 2 + q * hd * n * 2)
    rest = nblk * (q + pairs * 2 + q * hd * 2 + q * hd + hd * n * 2)
    nbytes = (itemsize * (2 * b * s * h * hd + b * s * h + 2 * b * s * n)
              + (8 if with_state else 4 if final_state else 0)
              * b * h * hd * n)
    return Cost(prod + rest, nbytes, exps, prod)


def ssd_bwd(b, s, h, hd, n, q, itemsize=4) -> Cost:
    """The chunked SSD's gradient: C.B^T over j <= t once per (b, chunk)
    (shared by the heads); per (b, h, chunk) the cumsum, the state entering
    the chunk (the forward's state walk), the decay exps, dM = dY.x^T,
    M^T.dY, dG.B and dG^T.C over j <= t, M, dG and dM o M there and the
    strict row and column sums of dM o M, dS.B, dY.S_in, x.dS and the dS
    update at hd x N per step, R, the inter-chunk term, <dS, S_in>, dcum
    and its reverse cumsum; dB and dC summed over the heads.  x, dA, B, C
    and dY read once, dx, d(dA), dB and dC written once."""
    pairs, chunks = q * (q + 1) // 2, (s // q) * b
    strict, nblk = q * (q - 1) // 2, chunks * h
    exps = nblk * (pairs + 2 * q)
    prod = chunks * pairs * n * 2 + nblk * (
        q * hd * n * 2 * 5 + pairs * hd * 2 * 2 + pairs * n * 2 * 2)
    rest = 2 * b * s * n * (h - 1) + nblk * (
        q + q * hd + hd * n * 2                         # cumsum, state walk
        + pairs * 3 + strict * 2                        # M, dG, P; sums
        + q * hd * 2                                    # dx
        + q * hd * 2 + q                                # R
        + q * n * 2                                     # dC
        + q * n * 2 + q                                 # inter-chunk term
        + q * n * 2                                     # dB
        + hd * n * 2                                    # <dS, S_in>
        + q * hd + hd * n * 2                           # dS update
        + q * 5)                                        # dcum, reverse cumsum
    nbytes = itemsize * (3 * b * s * h * hd + 2 * b * s * h + 4 * b * s * n)
    return Cost(prod + rest, nbytes, exps, prod)


def tiled_matmul(k, m, n, itemsize) -> Cost:
    """C = A^T B: 2 K M N FLOPs, A and B read once and C written once."""
    return Cost(2.0 * k * m * n, itemsize * (k * m + k * n + m * n))


# ---------------------------------------------------------------------------
# The analysis's hook
# ---------------------------------------------------------------------------

_active = None      # the running analysis (launch.hlo_analysis's counter)


def set_active(counter):
    """Install `counter` (or None) as the analysis kernel ops report to;
    returns the one it replaces."""
    global _active
    prev, _active = _active, counter
    return prev


@contextlib.contextmanager
def kernel_call(name: str, cost_fn):
    """Around one kernel op call: while an analysis is active, records
    `cost_fn()` (a `Cost`) once under `name` and stops the aten ops run
    inside from being counted.  Does nothing otherwise (`cost_fn` is not
    called)."""
    counter = _active
    if counter is None:
        yield
        return
    counter.record_kernel(name, cost_fn())
    with counter.suspended():
        yield
