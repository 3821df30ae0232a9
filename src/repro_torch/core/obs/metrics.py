"""Lock-cheap metrics primitives: counters, gauges, histograms, and the
registry that owns them; the port's copy of the JAX package's
`repro.core.obs.metrics`.

Design rules (the instrumentation-overhead budget depends on them):

  * **Single-writer updates are unlocked.**  `Counter.inc` /
    `Histogram.observe` mutate plain slots under the GIL with no lock —
    each hot-path metric has exactly one writer thread (the dispatch
    loop, one frontend coalescer, one client thread), so unlocked
    updates are exact there.  The rare multi-writer metric tolerates an
    occasionally-lost increment: monitoring reads are approximate by
    nature, and a lock on the hot path is the one cost this subsystem
    must not impose.
  * **Callback instruments cost nothing until scraped.**  A counter or
    gauge built with `fn=` reads an existing engine/frontend attribute
    (live worker count, ready depth, terminal totals) at dump time —
    the hot loop maintains those values anyway, so attaching metrics
    adds zero instructions to it.
  * **Histograms have fixed bucket boundaries** chosen at creation
    (default: a µs-to-10 s latency ladder), so `observe` is one C
    `bisect` + one list-slot increment, and the Prometheus exposition
    needs no per-scrape aggregation.

Registry creation (`counter()`/`gauge()`/`histogram()`) is
get-or-create keyed by (name, labels) and IS locked — it happens once
per metric, not per update.  `dump()` returns a JSON-able snapshot;
`prometheus()` renders the text exposition format (version 0.0.4).
"""
from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Callable, Optional

# µs .. 10 s: wide enough for in-proc rpc (~1 µs) and batched model
# inference (~seconds) on one ladder, small enough to bisect cheaply
LATENCY_BUCKETS = (
    1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)


def _fmt(v: float) -> str:
    """Prometheus sample-value formatting (ints stay ints)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    if v != v:                    # NaN
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def _escape(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


class Counter:
    """Monotonically-increasing count.  `fn=` makes it a callback
    counter: the value is read from an existing attribute at scrape
    time and `inc()` is forbidden (the owner already counts)."""

    kind = "counter"
    __slots__ = ("name", "help", "labels", "_value", "_fn")

    def __init__(self, name: str, help: str = "", labels: Optional[dict] = None,
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0
        self._fn = fn

    def inc(self, n=1):
        if self._fn is not None:
            raise RuntimeError(f"{self.name} is a callback counter")
        self._value += n

    @property
    def value(self):
        if self._fn is not None:
            try:
                return self._fn()
            except Exception:    # noqa: BLE001 — monitoring must never
                return 0         # take the observed system down
        return self._value


class Gauge:
    """A value that can go up and down; `fn=` for callback gauges."""

    kind = "gauge"
    __slots__ = ("name", "help", "labels", "_value", "_fn")

    def __init__(self, name: str, help: str = "", labels: Optional[dict] = None,
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0.0
        self._fn = fn

    def set(self, v):
        self._value = v

    def inc(self, n=1):
        self._value += n

    def dec(self, n=1):
        self._value -= n

    @property
    def value(self):
        if self._fn is not None:
            try:
                return self._fn()
            except Exception:    # noqa: BLE001
                return 0
        return self._value


class Histogram:
    """Fixed-boundary histogram: `buckets` are ascending upper bounds in
    the observed unit (seconds for latencies); counts[i] is the number of
    observations <= buckets[i], with one extra overflow slot (+Inf)."""

    kind = "histogram"
    __slots__ = ("name", "help", "labels", "buckets", "counts",
                 "sum", "count")

    def __init__(self, name: str, help: str = "", labels: Optional[dict] = None,
                 buckets=LATENCY_BUCKETS):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float):
        self.counts[bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (0 on empty)."""
        total = self.count
        if total <= 0:
            return 0.0
        target = q * total
        cum = 0
        lo = 0.0
        for i, c in enumerate(self.counts):
            hi = self.buckets[i] if i < len(self.buckets) else self.buckets[-1]
            if cum + c >= target:
                if c == 0 or i >= len(self.buckets):
                    return hi
                frac = (target - cum) / c
                return lo + (hi - lo) * frac
            cum += c
            lo = hi
        return self.buckets[-1]

    def snapshot(self) -> dict:
        counts = list(self.counts)            # one pass, consistent-ish
        out, cum = {}, 0
        for bound, c in zip(self.buckets, counts):
            cum += c
            out[_fmt(bound)] = cum
        out["+Inf"] = cum + counts[-1]
        return {"count": self.count, "sum": self.sum, "buckets": out}


class MetricsRegistry:
    """Owns every metric of one observed system.  Get-or-create accessors
    are keyed by (name, labels); asking for an existing key returns the
    same instance (so hot-path callers can cache it), and a kind
    mismatch raises."""

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ create
    def _get(self, cls, name: str, help: str, labels, **kw):
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help=help, labels=labels, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}")
            return m

    def counter(self, name: str, help: str = "", *,
                labels: Optional[dict] = None,
                fn: Optional[Callable] = None) -> Counter:
        return self._get(Counter, name, help, labels, fn=fn)

    def gauge(self, name: str, help: str = "", *,
              labels: Optional[dict] = None,
              fn: Optional[Callable] = None) -> Gauge:
        return self._get(Gauge, name, help, labels, fn=fn)

    def histogram(self, name: str, help: str = "", *,
                  labels: Optional[dict] = None,
                  buckets=LATENCY_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    # -------------------------------------------------------------- read
    def _items(self) -> list:
        with self._lock:
            return list(self._metrics.values())

    @staticmethod
    def _key(m) -> str:
        if not m.labels:
            return m.name
        inner = ",".join(f'{k}="{_escape(v)}"'
                         for k, v in sorted(m.labels.items()))
        return f"{m.name}{{{inner}}}"

    def dump(self) -> dict:
        """JSON-able snapshot: {'counters': {...}, 'gauges': {...},
        'histograms': {...}} keyed by the label-qualified metric name."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in self._items():
            key = self._key(m)
            if m.kind == "histogram":
                out["histograms"][key] = m.snapshot()
            else:
                out[m.kind + "s"][key] = m.value
        return out

    def prometheus(self) -> str:
        """Text exposition (format version 0.0.4): # HELP / # TYPE once
        per metric family, then one sample line per labelset (histograms
        expand to cumulative _bucket{le=} series plus _sum/_count)."""
        lines: list[str] = []
        seen_family: set = set()
        for m in sorted(self._items(),
                        key=lambda m: (m.name, sorted(m.labels.items()))):
            if m.name not in seen_family:
                seen_family.add(m.name)
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.kind}")
            base = sorted(m.labels.items())
            if m.kind == "histogram":
                snap = m.snapshot()
                for le, cum in snap["buckets"].items():
                    lbl = ",".join(f'{k}="{_escape(v)}"'
                                   for k, v in base + [("le", le)])
                    lines.append(f"{m.name}_bucket{{{lbl}}} {cum}")
                suffix = ("{" + ",".join(f'{k}="{_escape(v)}"'
                                         for k, v in base) + "}"
                          if base else "")
                lines.append(f"{m.name}_sum{suffix} {_fmt(snap['sum'])}")
                lines.append(f"{m.name}_count{suffix} {snap['count']}")
            else:
                suffix = ("{" + ",".join(f'{k}="{_escape(v)}"'
                                         for k, v in base) + "}"
                          if base else "")
                lines.append(f"{m.name}{suffix} {_fmt(m.value)}")
        return "\n".join(lines) + "\n"
