"""Unified execution engine: one worker-pool substrate for all three
schedulers (Rogers 2021), the port's copy of the JAX package's
`repro.core.engine`.

The paper's central claim is that pmake, dwork, and mpi-list "have the
same bottlenecks" and "well-understood per-task overhead".  This subsystem
makes that claim *measurable* in one place instead of three ad-hoc loops:

    model.py     Task / TaskResult / TraceEvent lifecycle data model
                 (created -> ready -> stolen -> running -> completed/
                  failed/requeued), mapped to the paper's Fig. 2 protocol
    backends.py  scheduler state adapters (dwork TaskServer, ShardedHub,
                 forwarding-tree TreeBackend) speaking the Table 2 verbs
                 incl. the batched CompleteSteal; every call timed as an
                 `rpc` event (tree hops as `op="hop:L<k>"`)
    executor.py  the worker pool: inproc / thread / tree / proc
                 transports, CompleteSteal piggybacking (complete+steal
                 in one RTT), Steal-n batching, sharded routing,
                 heap-scheduled slots/priority launch (pmake EFT)
    comm/        the transport registry: Connector/Listener pairs per
                 address scheme, TransportFamily per `transport=` name;
                 the proc family spawns worker PROCESSES speaking
                 Table-2 frames over TCP (Hello handshake, heartbeat
                 leases, cloudpickle at the boundary, multi-host join
                 via `python -m repro_torch.core.engine.comm.worker`)
    faults.py    heartbeat leases, dead-worker requeue, seeded fault and
                 straggler injection (no wall-clock dependence in tests)
    journal.py   write-ahead journal + compacted checkpoints for the
                 Table-2 transitions; `Engine.recover(journal_dir)`
                 rebuilds a crashed session (docs/robustness.md)
    tracing.py   empirical per-task overhead + METG from event streams
                 (optionally rpc-sampled), cross-checked against the
                 analytic laws in core/metg.py

Scheduler adapters built on this substrate:
    dwork    `repro_torch.core.dwork.pool.run_pool`  (TaskServer /
             ShardedHub)
    pmake    `repro_torch.core.pmake.PMake.run`      (slots=nodes, EFT
             priority)
    mpi-list `repro_torch.core.mpi_list.Context(..., engine_workers=...)`

Tuning `transport=` / `steal_n` against the METG laws (core/metg.py):

  * dwork's dispatch bound is METG(P) = rtt * P / (steal_n * shards)
    (§3, Table 4).  `steal_n` is the cheapest lever: it divides BOTH
    protocol directions now that completions piggyback on the next steal
    (`CompleteSteal`), at the cost of coarser work distribution — keep
    steal_n * task_duration well under the straggler horizon, and below
    the DAG's width / P so the tail of a batch can't serialize a level.
  * `transport="inproc"` measures pure scheduler cost (deterministic;
    use it for METG benchmarking and fault tests).  `transport="thread"`
    adds real concurrency for blocking tasks — use when task bodies hold
    the GIL < ~50% (popen'd scripts, I/O).  `transport="tree"` inserts a
    real forwarding tree (paper §4) in front of the hub: per-task rtt
    RISES by the per-hop relay cost (visible under `rpc_by_op` as
    `hop:L<k>`), but open connections at the hub drop from P to
    P/fanout^levels — pick it when connection count, not rtt, is the
    binding constraint, and size `tree_fanout` so each relay stays below
    ~fanout concurrent downstream frames per upstream round-trip.
    `transport="proc"` spawns real worker processes — the only family
    whose CPU-bound tasks scale with cores (the others serialize on the
    GIL) — at the highest per-task cost (fork + cloudpickle + socket
    rtt): callables must pickle (`SerializationError` at submit time
    otherwise), failures surface as error reprs, and a SIGKILLed
    worker's in-flight work requeues with zero loss via heartbeat
    leases.
  * `shards=N` multiplies dispatch rate by N for independent-task loads;
    cross-shard dependencies pay a proxy/notify round-trip, so shard
    only DAGs whose cut between shards is small (hash routing makes the
    cut ~ (1 - 1/N) of edges — prefer wide, shallow graphs).
  * `transport="tree", shards=N` COMPOSES the two levers (the paper's
    Summit-scale shape): the top-level tree node routes the Table 2
    verbs by task hash to per-shard servers (a ShardedHub behind the
    tree), so the connection bound AND the single-server dispatch bound
    fall together — `rpc_by_op` attributes relay levels as `hop:L<k>`
    and the apex shard fan-out as `hop:L1:s<j>`.

Rendered, example-driven versions of this guidance live in
docs/tuning.md (and the layer map in docs/architecture.md).
"""
from repro_torch.core.engine.backends import (DONE, EMPTY, ServerBackend,
                                              ShardedBackend, TreeBackend)
from repro_torch.core.engine.executor import Engine, EngineReport
from repro_torch.core.engine.faults import FaultPlan
from repro_torch.core.engine.journal import Journal, JournalState
from repro_torch.core.engine.model import (BATCH_FORMED, CANCELLED, COMPLETED,
                                           CREATED, FAILED, READY, REQ_DONE,
                                           REQ_ENQUEUED, REQ_REJECTED,
                                           REQ_TIMEOUT, REQUEUED, RETRIED, RPC,
                                           RUN_END, RUN_START, STOLEN,
                                           WORKER_DEAD, EngineTask,
                                           ManualClock, RetryPolicy,
                                           TaskResult, TraceEvent, WorkerCrash)
from repro_torch.core.engine.tracing import (LatencyReport, OverheadReport,
                                             TraceRecorder, crosscheck,
                                             percentile)

__all__ = [
    "Engine", "EngineReport", "EngineTask", "TaskResult", "TraceEvent",
    "TraceRecorder", "OverheadReport", "LatencyReport", "FaultPlan",
    "Journal", "JournalState", "RetryPolicy",
    "ManualClock", "WorkerCrash", "percentile",
    "ServerBackend", "ShardedBackend", "TreeBackend", "crosscheck",
    "DONE", "EMPTY",
    "CREATED", "READY", "STOLEN", "RUN_START", "RUN_END", "COMPLETED",
    "FAILED", "REQUEUED", "RETRIED", "CANCELLED", "WORKER_DEAD", "RPC",
    "REQ_ENQUEUED", "REQ_DONE", "REQ_REJECTED", "REQ_TIMEOUT",
    "BATCH_FORMED",
]
