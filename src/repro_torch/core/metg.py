"""Minimum Effective Task Granularity models (Rogers 2021, §3-§6).

METG = task duration at which scheduling overhead equals compute time.
Each scheduler archetype follows a different scaling law:

  pmake    METG(P) = jsrun(P) + alloc           jsrun ~ a + b*log(P)
  dwork    METG(P) = rtt * P                    single-server dispatch bound
           (mitigations: Steal-n batching  -> rtt*P/n;
            forwarding tree adds hop latency but removes connection limits;
            sharded servers -> rtt*P/shards)
  mpi-list METG(P) = straggler gap = E[max-min] of per-rank runtimes
           ~ sigma * sqrt(2 ln P) (Gumbel / extreme-value law, ref [31])

Paper-measured constants (Summit, Table 4) are kept as defaults so the
benchmarks can validate our reproduction against the paper's own numbers.
They are the paper's, measured on Summit, never this port's.  The port's
copy of the JAX package's `repro.core.metg`, unchanged.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

# paper Table 4 (seconds)
PAPER_JSRUN = {6: 0.987, 60: 1.783, 864: 2.336, 6912: 3.823}
PAPER_ALLOC = 1.81
PAPER_DWORK_RTT = 23e-6
PAPER_MPILIST_SYNC = {6: 0.09, 60: 0.17, 864: 0.33, 6912: 0.47}
# paper §4: METG at 864 ranks (seconds)
PAPER_METG_864 = {"mpi-list": 0.3e-3, "dwork": 25e-3, "pmake": 4.5}


def fit_log(points: dict) -> tuple[float, float]:
    """Least-squares fit y = a + b*ln(x)."""
    xs = [math.log(x) for x in points]
    ys = list(points.values())
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    b = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / \
        sum((x - mx) ** 2 for x in xs)
    return my - b * mx, b


@dataclass
class METGModel:
    jsrun_a: float = 0.0
    jsrun_b: float = 0.0
    alloc: float = PAPER_ALLOC
    dwork_rtt: float = PAPER_DWORK_RTT
    sync_a: float = 0.0
    sync_b: float = 0.0

    @classmethod
    def from_paper(cls) -> "METGModel":
        ja, jb = fit_log(PAPER_JSRUN)
        sa, sb = fit_log({p: v for p, v in PAPER_MPILIST_SYNC.items()})
        return cls(jsrun_a=ja, jsrun_b=jb, sync_a=sa, sync_b=sb)

    @classmethod
    def from_measured(cls, *, launch_s: float = 0.0, alloc_s: float = 0.0,
                      rtt_s: float = PAPER_DWORK_RTT) -> "METGModel":
        """Instantiate the scaling laws with constants measured on the
        running system (engine trace / benchmarks) instead of the paper's
        Summit numbers: launch_s -> flat jsrun cost, rtt_s -> dwork
        dispatch RTT.  Used by `engine.tracing.crosscheck` to validate the
        law *shapes* against empirical event streams."""
        return cls(jsrun_a=launch_s, jsrun_b=0.0, alloc=alloc_s,
                   dwork_rtt=rtt_s)

    # -- scaling laws ------------------------------------------------------
    def jsrun_time(self, ranks: int) -> float:
        return self.jsrun_a + self.jsrun_b * math.log(max(ranks, 1))

    def pmake_metg(self, ranks: int) -> float:
        """Launch cost is unhideable per task (paper §4)."""
        return self.jsrun_time(ranks) + self.alloc

    def dwork_metg(self, ranks: int, *, steal_n: int = 1,
                   shards: int = 1) -> float:
        """Single server must serve every rank per task interval."""
        return self.dwork_rtt * ranks / (max(steal_n, 1) * max(shards, 1))

    def mpilist_metg(self, ranks: int, *, per_rank_sigma: float = 0.0) -> float:
        """Straggler gap; with a measured sigma use the Gumbel law, else the
        paper's fitted sync-latency curve."""
        if per_rank_sigma > 0.0:
            return per_rank_sigma * math.sqrt(2.0 * math.log(max(ranks, 2)))
        return max(self.sync_a + self.sync_b * math.log(max(ranks, 1)), 0.0) \
            * 1e-3  # paper's sync column is dominated by per-1024-task cost

    def metg(self, scheduler: str, ranks: int, **kw) -> float:
        return {"pmake": self.pmake_metg, "dwork": self.dwork_metg,
                "mpi-list": self.mpilist_metg}[scheduler](ranks, **kw)


def same_order(a: float, b: float, factor: float = 10.0) -> bool:
    """True when two positive quantities agree to within `factor` (default:
    one order of magnitude) — the engine's empirical-vs-analytic check."""
    if a <= 0.0 or b <= 0.0:
        return False
    return max(a, b) / min(a, b) <= factor


def efficiency(task_time: float, metg: float) -> float:
    """Fraction of wall time spent computing when per-task overhead equals
    the METG-implied overhead: eff = t / (t + overhead)."""
    return task_time / (task_time + metg)


def pick_batch_size(scheduler: str, ranks: int, per_task_s: float,
                    target_eff: float = 0.9, model: METGModel = None,
                    shards: int = 1) -> int:
    """METG-aware batching (framework feature): how many requests/steps to
    bundle per task so scheduling overhead stays below (1-target_eff).
    `shards` divides dwork's dispatch bound (a sharded hub — alone or
    behind the forwarding tree — multiplies dispatch rate), so a sharded
    deployment needs proportionally smaller batches for the same
    efficiency target; the other scheduler laws ignore it."""
    m = model or METGModel.from_paper()
    kw = {"shards": max(int(shards), 1)} if scheduler == "dwork" else {}
    overhead = m.metg(scheduler, ranks, **kw)
    # t*n / (t*n + overhead) >= eff  =>  n >= overhead*eff / (t*(1-eff))
    n = overhead * target_eff / (per_task_s * (1.0 - target_eff))
    return max(1, math.ceil(n))
