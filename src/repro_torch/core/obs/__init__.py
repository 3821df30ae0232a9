"""Live observability for the unified engine, serving layer, and client;
the port's copy of the JAX package's `repro.core.obs`.

Three pieces, designed to compose (see `docs/observability.md`):

  * `metrics`      — lock-cheap Counter/Gauge/Histogram primitives and
                     the `MetricsRegistry` (JSON dump + Prometheus text)
  * `instrument`   — wires a registry onto a live Engine / Client /
                     Frontend: callback instruments over state the hot
                     loop maintains anyway, plus sampled rpc and
                     per-request latency histograms
  * `server`       — `StatsServer`: `/stats`, `/health`, `/metrics`
                     over stdlib `http.server`;
    `top`          — `python -m repro_torch.core.obs.top` text dashboard
  * `chrome_trace` — `to_chrome_trace`: the `TraceRecorder` event log
                     as a Perfetto-loadable timeline (also available as
                     `TraceRecorder.to_chrome_trace(path)`), with an
                     optional critical-path lane + flow arrows
  * `critical_path` — `CriticalPathReport`: post-hoc causal analysis of
                     a run (makespan decomposition, concurrency vs the
                     METG-law ideal, idle gaps, stragglers);
    `explain`      — `python -m repro_torch.core.obs.explain <trace>` CLI
                     and the text renderer over it

The one-call front door is `Client.stats_server()`; everything here
also works piecemeal on a bare `Engine`.
"""
from repro_torch.core.obs.chrome_trace import to_chrome_trace
from repro_torch.core.obs.critical_path import CriticalPathReport
from repro_torch.core.obs.instrument import (RPC_BUCKETS, RpcMetrics,
                                             ServingMetrics, instrument)
from repro_torch.core.obs.metrics import (LATENCY_BUCKETS, Counter, Gauge,
                                          Histogram, MetricsRegistry)
from repro_torch.core.obs.server import StatsServer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "LATENCY_BUCKETS", "RPC_BUCKETS",
    "RpcMetrics", "ServingMetrics", "instrument",
    "StatsServer", "to_chrome_trace", "CriticalPathReport",
]
