"""The device trace of a `--trace 1` run: torch.profiler over the measured
window, read from its raw events (no tree is built).  Gives the kernels
(name, start, duration), the union of their intervals (busy), the top
device operations, and the longest idle gaps, each named by the innermost
host operation that was running in it."""
from __future__ import annotations

import bisect
from collections import defaultdict

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    def __init__(self, kernels: list, host: list):
        self.kernels = sorted(kernels, key=lambda k: k[1])   # (name, t0, dt) ns
        self.host = host                                      # (name, t0, t1) ns

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose name contains any of `names`."""
        return sum(dt for n, _, dt in self.kernels
                   if any(s in n for s in names)) * 1e-9

    def intervals(self) -> list:
        """The union of the device operations' intervals, merged, in ns."""
        out = []
        for _, t0, dt in self.kernels:
            t1 = t0 + dt
            if out and t0 <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t1)
            else:
                out.append([t0, t1])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals()) * 1e-9

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(int)
        for name, _, dt in self.kernels:
            by[name] += dt
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], dt * 1e-9] for name, dt in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The n longest gaps between device operations, each named by the
        innermost host operation spanning the gap's middle."""
        iv = self.intervals()
        gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(iv, iv[1:])),
                      reverse=True)[:n]
        starts = [h[1] for h in self.host]
        out = []
        for length, g0, g1 in gaps:
            mid = (g0 + g1) // 2
            best = None
            last = bisect.bisect_right(starts, mid) - 1
            for i in range(last, max(last - 20000, -1), -1):
                name, h0, h1 = self.host[i]
                if h1 >= mid and (best is None or h1 - h0 < best[1]):
                    best = (name, h1 - h0)
            out.append([best[0][:160] if best else "host idle",
                        length * 1e-9])
        return out


def collect(prof) -> Trace:
    """The Trace of a stopped torch.profiler.profile."""
    from torch.autograd import DeviceType
    kernels, host = [], []
    for e in prof.profiler.kineto_results.events():
        t0, dt = _times(e)
        if e.device_type() == DeviceType.CUDA:
            if _kind(e) in DEVICE_KINDS:
                kernels.append((e.name(), t0, dt))
        else:
            host.append((e.name(), t0, t0 + dt))
    host.sort(key=lambda h: h[1])
    return Trace(kernels, host)


def _times(e):
    """(start, duration) in ns; older torch gives microseconds only."""
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.duration_ns()
    return int(e.start_us() * 1000), int(e.duration_us() * 1000)


def _kind(e) -> str:
    """A device event's kind; where torch does not say, a user annotation
    is told apart by its flag or else taken for a kernel."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    if getattr(e, "is_user_annotation", lambda: False)():
        return "gpu_user_annotation"
    return "kernel"


def start():
    """A running profiler of host and device activity."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof
