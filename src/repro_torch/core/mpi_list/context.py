"""In-process mpi-list: Context + DFM with the paper's exact partition law;
the port's copy of the JAX package's `repro.core.mpi_list.context`.

The rank loop is sequential (one process), but every operation is expressed
rank-locally — the same code shape as the mpi4py original — and the
partition invariant (contiguous ascending blocks, paper §2.3) is enforced
and property-tested.

Engine-backed multi-rank mode: `Context(P, engine_workers=W)` dispatches
the map-family bulk steps (map / flatMap / filter — the `_timed` path)
as tasks on the unified engine pool (`repro_torch.core.engine`), one task
per rank per superstep — the BSP analog of the paper's Fig. 2 dispatch.
Reductions and data movement (reduce / scan / repartition / group) stay
in-process.  Seeded straggler injection (`straggler_sigma`) adds
deterministic virtual jitter to per-rank times; the accumulated max-min
sync gaps feed the Gumbel extreme-value law
`METGModel.mpilist_metg(P, per_rank_sigma=sigma)` via
`Context.straggler_crosscheck()`.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Iterable, Optional


def partition_bounds(N: int, P: int, p: int) -> tuple[int, int]:
    """Start/end of rank p's block: start = p*(N//P) + min(p, N%P)."""
    start = p * (N // P) + min(p, N % P)
    length = N // P + (1 if p < N % P else 0)
    return start, start + length


class Context:
    """Communicator stand-in. `procs` ranks, rank-local jitter optional
    (straggler modelling for the METG benchmark).

    With `engine_workers` (or `straggler_sigma` > 0) set, bulk operations
    run through the unified engine pool — one task per rank per superstep —
    and per-step sync gaps are recorded in `self.gaps`/`self.rank_times`.
    """

    def __init__(self, procs: int = 1, *,
                 jitter: Optional[Callable[[int], float]] = None,
                 engine_workers: Optional[int] = None,
                 straggler_sigma: float = 0.0, seed: int = 0):
        self.procs = procs
        self.rank = 0                   # in-proc: we "are" every rank in turn
        self.jitter = jitter
        self.sync_time = 0.0            # accumulated straggler gap (modelled)
        self.engine_workers = engine_workers
        self.straggler_sigma = straggler_sigma
        self.seed = seed
        self.engine_enabled = engine_workers is not None or straggler_sigma > 0
        self.step = 0                   # superstep counter (engine mode)
        self.gaps: list[float] = []     # per-step max-min rank-time gap
        self.rank_times: list[list[float]] = []
        # injected-jitter-only gaps: exactly reproducible for a fixed seed
        # (real per-rank times always carry wall-clock noise)
        self.virtual_gaps: list[float] = []

    # -- constructors ------------------------------------------------------
    def iterates(self, N: int) -> "DFM":
        parts = []
        for p in range(self.procs):
            s, e = partition_bounds(N, self.procs, p)
            parts.append(list(range(s, e)))
        return DFM(self, parts)

    def scatter(self, xs: list) -> "DFM":
        N = len(xs)
        parts = []
        for p in range(self.procs):
            s, e = partition_bounds(N, self.procs, p)
            parts.append(list(xs[s:e]))
        return DFM(self, parts)

    # -- BSP sync point (straggler accounting) -----------------------------
    def _sync(self, per_rank_times: Optional[list] = None):
        if per_rank_times:
            self.sync_time += max(per_rank_times) - min(per_rank_times)

    # -- engine-backed superstep (one task per rank) -----------------------
    def _engine_step(self, parts: list, g: Callable) -> list:
        """Dispatch one bulk operation through the futures client (batch
        mode, one future per rank): rank p's block becomes task
        `rank{p}.step{s}`; per-rank times (real + any injected virtual
        straggler jitter) are recorded and synced.  A shim over
        `repro_torch.client.Client`, same as the other front doors."""
        from repro_torch.client import Client
        from repro_torch.core.engine.faults import FaultPlan

        faults = None
        if self.straggler_sigma > 0:
            faults = FaultPlan(seed=self.seed * 1_000_003 + self.step)
            faults.stragglers(self.straggler_sigma)
        workers = self.engine_workers or min(self.procs, 8)
        client = Client(scheduler="mpi_list", workers=max(workers, 1),
                        transport="inproc",
                        steal_n=max(1, self.procs // max(workers, 1)),
                        faults=faults, resident=False)
        futs = [client.submit(g, blk, key=f"rank{p}.step{self.step}")
                for p, blk in enumerate(parts)]
        try:
            client.run()
        finally:
            client.close()
        out, times, virtuals = [], [], []
        for p, fut in enumerate(futs):
            err = fut.exception()
            if err is not None:
                raise RuntimeError(f"mpi-list rank {p} failed: {err!r}")
            res = fut.task_result
            if res is None:
                raise RuntimeError(f"mpi-list rank {p} failed: lost task")
            out.append(fut.result())
            dt = res.duration_s
            if self.jitter is not None:
                dt += self.jitter(p)
            times.append(dt)
            virtuals.append(res.virtual_s)
        self.step += 1
        self.rank_times.append(times)
        self.gaps.append(max(times) - min(times))
        self.virtual_gaps.append(max(virtuals) - min(virtuals))
        self._sync(times)
        return out

    def straggler_crosscheck(self, factor: float = 10.0) -> dict:
        """Empirical mean sync gap vs the Gumbel law sigma*sqrt(2 ln P)
        (paper §3, ref [31]) evaluated at the injected sigma."""
        from repro_torch.core.engine.tracing import crosscheck
        from repro_torch.core.metg import METGModel

        if not self.gaps:
            raise ValueError("no engine-mode supersteps recorded")
        if self.straggler_sigma <= 0.0:
            raise ValueError(
                "straggler_crosscheck needs injected jitter "
                "(straggler_sigma > 0); with sigma=0 the model side would "
                "fall back to the paper's Summit-fitted sync curve, which "
                "says nothing about this run")
        emp = sum(self.gaps) / len(self.gaps)
        ana = METGModel.from_paper().mpilist_metg(
            self.procs, per_rank_sigma=self.straggler_sigma)
        return crosscheck("mpi-list", emp, ana, factor=factor)


class DFM:
    """Distributed free monoid: list of per-rank blocks."""

    def __init__(self, C: Context, parts: list):
        assert len(parts) == C.procs
        self.C = C
        self.parts = parts

    # -- embarrassingly parallel ops (no sync) ------------------------------
    def map(self, f: Callable) -> "DFM":
        return self._timed(lambda blk: [f(x) for x in blk])

    def flatMap(self, f: Callable) -> "DFM":
        return self._timed(lambda blk: [y for x in blk for y in f(x)])

    def filter(self, pred: Callable) -> "DFM":
        return self._timed(lambda blk: [x for x in blk if pred(x)])

    def _timed(self, g: Callable) -> "DFM":
        if self.C.engine_enabled:
            return DFM(self.C, self.C._engine_step(self.parts, g))
        out, times = [], []
        for p, blk in enumerate(self.parts):
            t0 = time.perf_counter()
            out.append(g(blk))
            dt = time.perf_counter() - t0
            if self.C.jitter is not None:
                dt += self.C.jitter(p)
            times.append(dt)
        self.C._sync(times)
        return DFM(self.C, out)

    # -- reductions (sync) ---------------------------------------------------
    def len(self) -> int:
        return sum(len(b) for b in self.parts)

    def reduce(self, f: Callable, zero: Any) -> Any:
        acc = zero
        for blk in self.parts:
            for x in blk:
                acc = f(acc, x)
        return acc

    def scan(self, f: Callable, zero: Any) -> "DFM":
        """Inclusive prefix scan over the global list order."""
        out, acc = [], zero
        for blk in self.parts:
            cur = []
            for x in blk:
                acc = f(acc, x)
                cur.append(acc)
            out.append(cur)
        return DFM(self.C, out)

    def collect(self) -> list:
        return [x for blk in self.parts for x in blk]

    def head(self, n: int = 10) -> list:
        return self.collect()[:n]

    # -- data movement -------------------------------------------------------
    def repartition(self, len_f: Callable, split_f: Callable,
                    concat_f: Callable) -> "DFM":
        """Re-balance treating each element as a container of records
        (paper: len / subdivide / combine functions).  The result is one
        combined element per rank, with records split by the partition law."""
        records = []
        for blk in self.parts:
            for x in blk:
                n = len_f(x)
                records.extend(split_f(x, n))   # one chunk per record
        N = len(records)
        parts = []
        for p in range(self.C.procs):
            s, e = partition_bounds(N, self.C.procs, p)
            parts.append([concat_f(records[s:e])] if e > s else [])
        return DFM(self.C, parts)

    def group(self, dest_f: Callable, combine_f: Callable) -> "DFM":
        """dest_f: element -> {dest_index: [records]}; records are shipped to
        `dest_index` (mod procs) and combined per destination."""
        P = self.C.procs
        inbox: dict[int, list] = {}
        for blk in self.parts:
            for x in blk:
                for dest, recs in dest_f(x).items():
                    inbox.setdefault(dest % P, []).extend(recs)
        parts = []
        for p in range(P):
            parts.append([combine_f(p, inbox[p])] if p in inbox else [])
        return DFM(self.C, parts)

    # -- invariants (property-tested) ---------------------------------------
    def check_partition_law(self):
        """Blocks must be contiguous ascending when elements are ints."""
        flat = self.collect()
        sizes = [len(b) for b in self.parts]
        N, P = sum(sizes), self.C.procs
        for p in range(P):
            s, e = partition_bounds(N, P, p)
            assert sizes[p] == e - s, (p, sizes[p], e - s)
        return flat
