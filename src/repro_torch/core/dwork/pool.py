"""dwork engine adapter: dispatch a TaskServer / ShardedHub through the
unified worker pool; the port's copy of the JAX package's
`repro.core.dwork.pool`.  `transport="tree"` raises `NotImplementedError`
until the forwarding tree is ported.

`run_pool(server, execute, workers=4)` replaces hand-rolled
`Client.run_loop` loops: the engine's pool speaks the same Steal /
Complete / Exit protocol (Fig. 2) against the given server, with Steal-n
batching, per-worker fault injection, and a lifecycle trace from which
empirical per-task overhead and METG are computed
(`report.overhead().summary()`).

Since the futures redesign this is a thin shim over the batch mode of
`repro_torch.client.Client` — the same front door the dynamic futures API
uses — kept for its task-universe-on-a-server calling convention.
"""
from __future__ import annotations

from typing import Callable, Optional


def run_pool(server, execute: Optional[Callable] = None, *,
             workers: int = 4, steal_n: int = 1, transport: str = "inproc",
             tracer=None, faults=None, clock=None, poll: float = 0.001,
             tree_fanout: int = 4, tree_levels: int = 1, **engine_kw):
    """Run every task on `server` to a terminal state through the engine
    pool.  `server` is a `TaskServer` or a `ShardedHub`;
    `execute(name, meta)` returns bool | (ok, value) | None (success).
    With `transport="tree"` every worker RPC crosses a forwarding tree
    (`tree_fanout` workers per leaf Forwarder, `tree_levels` relay
    layers) in front of the server.  Returns the `EngineReport` (results,
    trace, errors, backend stats)."""
    # lazy import: repro_torch.client imports engine modules that import
    # dwork submodules, so importing at module scope would create a cycle
    from repro_torch.client import Client

    client = Client(scheduler="dwork", workers=workers, steal_n=steal_n,
                    transport=transport, server=server, executor=execute,
                    resident=False, tracer=tracer, faults=faults,
                    clock=clock, poll=poll, tree_fanout=tree_fanout,
                    tree_levels=tree_levels, **engine_kw)
    try:
        return client.run()
    finally:
        client.close()
