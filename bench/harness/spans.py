"""Device seconds by program span, and the program's clock against the
device trace's.

The program names its layers with `repro_torch.core.engine.tracing.span`;
while a profiler records, each span is also a profiler range.  A device
operation (kernel, memcpy, memset) belongs to the program ranges that were
open when the CUDA runtime or driver call that launched it was made, the
call found by its correlation id among a stopped profiler's raw events:
the path of their names, outermost first.  The ranges of every thread
count, since the profiler does not tie a runtime call to its thread where
it records no operator around it, and the port launches its device work
from one thread, the engine's worker.  The profiler has to record that
thread: one records other threads than the one that started it only with
`profile_all_threads`.

`fit_clock` fits the line that takes the program's clock (`SPAN` events,
`time.perf_counter` seconds) to the profiler's (Unix-epoch ns), from the
spans that were also profiler ranges.  `queue_wait_ms` and
`turnaround_ms` read the front door's and the engine's SPAN events."""
from __future__ import annotations

from collections import defaultdict

PROGRAM = ("serve.", "serve_step.", "model.", "block.", "attention.")
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_KINDS = ("cuda_runtime", "cuda_driver")


def is_program(name: str) -> bool:
    return name.startswith(PROGRAM)


def kind(e) -> str:
    """A raw profiler event's kind (`activity_type`); where torch does not
    give it, told from the device, the annotation flag and the name."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    note = getattr(e, "is_user_annotation", lambda: False)()
    if str(e.device_type()).endswith("CUDA"):
        if note:
            return "gpu_user_annotation"
        name = e.name()
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    if note:
        return "user_annotation"
    return "cuda_runtime" if e.name().startswith("cu") else "cpu_op"


def paths(ranges: list, times: list) -> list:
    """For each of `times` (ascending), the names of the `ranges` ((t0,
    t1, name)) open at it, by start."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, open_, i = [], [], 0
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            open_.append(ranges[i])
            i += 1
        open_ = [r for r in open_ if r[1] >= t]
        out.append(tuple(r[2] for r in open_))
    return out


class SpanTime:
    """Device seconds under each path of program spans and, within it, by
    device operation ({(path, name): seconds}), the device seconds in all,
    and each program range's count."""

    def __init__(self, by_op: dict, total_s: float, counts: dict):
        self.by_op, self.total_s, self.counts = by_op, total_s, counts
        self.by_path = defaultdict(float)
        for (p, _), s in by_op.items():
            self.by_path[p] += s
        self.by_path = dict(self.by_path)

    def under(self, *names) -> float:
        """Device seconds of the operations launched inside every one of
        `names` (at any depth, in any order)."""
        return sum(s for p, s in self.by_path.items()
                   if all(n in p for n in names))

    def named_share(self) -> float:
        """The share of the device seconds launched inside some program
        span."""
        if self.total_s <= 0:
            return 0.0
        return sum(s for p, s in self.by_path.items() if p) / self.total_s

    def top_ops(self, *names, n: int = 6) -> list:
        """The n device operations with the most seconds under every one of
        `names`: [name, seconds], most first."""
        by = defaultdict(float)
        for (p, op), s in self.by_op.items():
            if all(x in p for x in names):
                by[op] += s
        return [[op, s] for op, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def innermost(self) -> dict:
        """Device seconds by innermost span ('' for none), largest first."""
        by = defaultdict(float)
        for p, s in self.by_path.items():
            by[p[-1] if p else ""] += s
        return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def from_events(events) -> SpanTime:
    """Attribution by correlation id, over a stopped profiler's raw events
    (`prof.profiler.kineto_results.events()`)."""
    ranges, calls, ops = [], {}, []
    for e in events:
        k = kind(e)
        t0 = e.start_ns()
        if k == "user_annotation" and is_program(e.name()):
            ranges.append((t0, t0 + e.duration_ns(), e.name()))
        elif k in CALL_KINDS:
            calls[e.correlation_id()] = t0
        elif k in DEVICE_KINDS:
            ops.append((e.correlation_id(), e.name(), e.duration_ns()))
    by_op = defaultdict(float)
    launched = sorted((calls[c], name, dt) for c, name, dt in ops
                      if c in calls)
    for p, (_, name, dt) in zip(paths(ranges, [t for t, _, _ in launched]),
                                launched):
        by_op[p, name] += dt * 1e-9
    for c, name, dt in ops:
        if c not in calls:                       # launched before the window
            by_op[(), name] += dt * 1e-9
    counts = defaultdict(int)
    for r in ranges:
        counts[r[2]] += 1
    return SpanTime(dict(by_op), sum(dt for _, _, dt in ops) * 1e-9,
                    dict(counts))


def _line(xs: list, ys: list) -> tuple:
    """(c, b) of the least-squares line y = c + b x."""
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    sxx = sum((x - mx) ** 2 for x in xs)
    b = (sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
         if sxx > 0 else 1.0)
    return my - b * mx, b


def fit_clock(span_events, profiler_ranges) -> tuple:
    """(place, distances): `place(t)` takes a time on the program's clock
    to the profiler's ns, by the line fitted over the starts and ends of
    the SPAN events (t0 in extra, t the end) paired with the profiler's
    program ranges ((t0 ns, t1 ns, name)) by name and order; `distances`
    are the paired stamps' distances from the line in seconds, ascending.
    The line is fitted by least squares twice, the second time without the
    stamps more than three median distances off it: a thread that loses
    the interpreter between a range's edge and its clock reading stamps
    late.  Each name must have as many ranges as events."""
    ev = defaultdict(list)
    for e in span_events:
        ev[e.extra["name"]].append((e.extra["t0"], e.t))
    rg = defaultdict(list)
    for a, b, name in profiler_ranges:
        if name in ev:
            rg[name].append((a, b))
    xs, ys = [], []
    for name, spans in ev.items():
        spans.sort()
        got = sorted(rg.get(name, []))
        if len(got) != len(spans):
            raise ValueError(f"{name}: {len(spans)} spans, {len(got)} "
                             f"profiler ranges")
        for (s0, s1), (r0, r1) in zip(spans, got):
            xs += [s0, s1]
            ys += [r0, r1]
    if len(xs) < 2:
        raise ValueError("no paired spans")
    x0, y0 = xs[0], ys[0]
    dx = [x - x0 for x in xs]
    dy = [(y - y0) * 1e-9 for y in ys]
    c, b = _line(dx, dy)
    off = [abs(y - c - b * x) for x, y in zip(dx, dy)]
    cut = 3 * sorted(off)[len(off) // 2]
    keep = [i for i, d in enumerate(off) if d <= cut]
    if len(keep) >= 2:
        c, b = _line([dx[i] for i in keep], [dy[i] for i in keep])

    def place(t: float) -> float:
        return y0 + (c + b * (t - x0)) * 1e9

    return place, sorted(abs(y - c - b * x) for x, y in zip(dx, dy))


def _spans(span_events, name: str) -> list:
    """The SPAN events of `name`, by start."""
    return sorted((e for e in span_events if e.extra["name"] == name),
                  key=lambda e: e.extra["t0"])


def queue_wait_ms(span_events):
    """Front door: the mean wait of a request from its enqueue to the
    start of its batch, from the `serve.batch` spans' `wait_sum_s` and
    `size`; None without one."""
    b = _spans(span_events, "serve.batch")
    n = sum(e.extra["size"] for e in b)
    return sum(e.extra["wait_sum_s"] for e in b) / n * 1e3 if n else None


def turnaround_ms(span_events, formed: list):
    """Engine: the mean time from the end of one batch's `serve.execute`
    to the start of the next one's, over the consecutive batches whose
    next batch had formed (`formed`: the BATCH_FORMED times of the same
    batches, in order) before that end; None without such a pair."""
    ex = _spans(span_events, "serve.execute")
    formed = sorted(formed)
    gaps = [b.extra["t0"] - a.t
            for a, b, f in zip(ex, ex[1:], formed[1:]) if f <= a.t]
    return sum(gaps) / len(gaps) * 1e3 if gaps else None
