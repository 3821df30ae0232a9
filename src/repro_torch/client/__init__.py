"""Futures-first client API: one front door for every scheduler and the
serving layer; the port's copy of the JAX package's `repro.client`.

The paper's three schedulers share one engine; this package
gives them one *interface*: `Client.submit(fn, *args) -> Future`, with
futures-as-dependencies (the `distributed`/Balsam shape).  A `Client`
owns a resident `Engine` — submit while it runs, no pre-declared task
universe — and every future resolves exactly once from the engine's
first-terminal notification, across `WorkerCrash` requeues and
heartbeat-lease expiries.  An upstream failure (or cancel) poisons its
transitive dependents, which surface `DependencyFailed`.

Quickstart — dwork (bag of dynamic tasks, work-stealing pool):

    from repro_torch.client import Client

    with Client(scheduler="dwork", workers=4, steal_n=4) as c:
        squares = [c.submit(lambda x=x: x * x, key=f"sq{x}") for x in range(100)]
        total = c.submit(sum, c.submit(lambda: [1, 2, 3]))   # future-as-dep
        print(c.gather(squares), total.result())
        print(c.report().summary())          # METG accounting, unchanged

Quickstart — pmake (EFT priorities, node slots):

    with Client(scheduler="pmake", workers=8) as c:
        shards = [c.submit(train_shard, i, priority=10 - i, slots=2)
                  for i in range(4)]
        summary = c.submit(summarize, *shards)    # waits on all four
        summary.result()

Quickstart — mpi_list (bulk-synchronous rank blocks):

    with Client(scheduler="mpi_list", workers=8) as c:
        blocks = [list(range(p * 100, (p + 1) * 100)) for p in range(8)]
        done = c.map(lambda blk: [x * 2 for x in blk], blocks)
        flat = [y for blk in c.gather(done) for y in blk]

Serving rides the same client (`repro_torch.core.serving` frontend):

    with Client(scheduler="dwork", workers=2, lease_timeout=30.0) as c:
        frontend = c.serve(execute_batch, max_wait_s=0.005)
        reply = frontend.submit(payload)
        reply.wait(); print(reply.value)

Long-lived sessions stay bounded with the opt-in knobs:
`Client(max_trace_events=100_000)` puts the trace on a ring buffer,
`keep_results=False` skips the engine's results history (futures hold
the values), and `prune_every=N` drops terminal entries from the
engine + server history tables every N resolved futures.

The legacy front doors — `repro_torch.core.dwork.run_pool`,
`repro_torch.core.pmake.PMake.run`,
`repro_torch.core.mpi_list.Context(engine_workers=...)` — and
`repro_torch.runtime.elastic.ElasticPool` are thin shims over this client
(batch mode, `Client(resident=False)` + `run()`, for the first three).
"""
from repro_torch.client.client import SCHEDULERS, Client
from repro_torch.client.futures import (CancelledError, DependencyFailed,
                                        Future, TaskFailed, as_completed)

__all__ = ["Client", "Future", "as_completed", "CancelledError",
           "DependencyFailed", "TaskFailed", "SCHEDULERS"]
