"""Continuous-serving subsystem: live traffic on the unified engine; the
port's copy of the JAX package's `repro.core.serving`.

The paper's schedulers are batch-oriented — submit a task universe, drain
it.  This package is the service-mode layer over the same substrate (the
gap Balsam / pilot-job systems fill over batch launchers): a resident
`Engine` (`resident=True`, `start()/submit()/drain()/shutdown()`) keeps
the dispatch loop running open-ended, and a `Frontend` turns a stream of
*requests* into METG-sized engine *tasks*:

    client -> Frontend.submit(payload)        bounded admission queue
                    |                          (block / reject backpressure)
              coalesce into a batch            size = pick_batch_size(...)
                    |                          OR max_wait_s deadline hit
              Engine task (resident pool)      steal/complete, faults,
                    |                          leases, tracing — unchanged
              ServeRequest.wait() -> value     REQ_* events -> LatencyReport

Everything the engine guarantees for tasks holds for requests: a worker
death mid-stream requeues the in-flight batch (announced Exit or
heartbeat-lease expiry) and the requests ride the re-execution — zero
loss, at-most-once response delivery (`ServeRequest` resolves once).

Tuning `batch`/`max_wait_s` against the METG laws (`core/metg.py`),
mirroring the engine docstring's `steal_n`/`transport` guidance:

  * The batch target is the serving analog of Steal-n: dwork's dispatch
    bound METG(P) = rtt * P means a batch must carry at least
    `pick_batch_size(P, t_req)` requests for scheduling overhead to stay
    under (1 - target_eff) of compute.  The frontend re-evaluates this
    every dispatch from the LIVE worker count (`engine.live_workers()` —
    deaths shrink P, elastic growth raises it) and an EWMA of observed
    per-request time measured on the trace clock, so granularity tracks
    the running system, not a config constant.
  * `max_wait_s` is the latency guard: a deadline dispatch sends a
    partial batch so a trickle of traffic is never starved waiting for a
    full one.  Keep it well under your latency SLO minus one batch
    service time; raising it trades p50 latency for throughput (bigger
    batches), and past the point where batches already hit the METG
    target it buys nothing.
  * `max_queue` bounds memory and wait time: by Little's law a full
    queue adds ~max_queue * t_req / P to tail latency, so size it to the
    worst p99 you are willing to serve and let backpressure
    (`policy="block"` to push back on the client, `"reject"` to fail
    fast) shed the rest.

Latency accounting lives in the engine trace: `REQ_ENQUEUED` /
`BATCH_FORMED` / `REQ_DONE` / `REQ_REJECTED` events feed
`engine.tracing.LatencyReport` (p50/p95/p99 enqueue->complete latency,
queue-depth stats), attached to `OverheadReport.requests` so one report
covers both the paper's overhead quantities and the serving SLOs.
"""
from repro_torch.core.serving.frontend import (AdmissionFull, Frontend,
                                               ServeRequest)

__all__ = ["Frontend", "ServeRequest", "AdmissionFull"]
