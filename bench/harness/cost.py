"""The work of one kernel call, counted from its shapes: a frozen copy of
the program's `kernels/cost.py` (flash attention's forward), so that the yardstick stays put whatever later changes make to
the program.  A test holds the copy equal to the program's file at a few
shapes while the two agree; where the program's count changes, this copy
is the benchmark's."""
from __future__ import annotations

from typing import NamedTuple


class Cost(NamedTuple):
    flops: float      # every FLOP
    nbytes: float     # each input read once, each output written once
    exps: float = 0.0  # the program's tuple has these two for its scans
    prod: float = 0.0


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
