"""Deterministic fault and straggler injection for the engine, the port's
copy of the JAX package's `repro.core.engine.faults` (the same draws for
the same seed).

All randomness is derived from a seed plus stable task/worker names, so a
given `FaultPlan` produces the same faults regardless of execution order or
wall clock — the property the fault-tolerance tests rely on.

Three fault families (mapped to the paper's failure modes):

  * worker death   — `kill_worker(w, after_steals=k)`: the worker dies once
                     it has stolen >= k tasks.  Announced deaths send
                     `Exit(worker)` (paper: node failure recycles its
                     assignment to the FRONT of the queue); silent deaths
                     send nothing and rely on heartbeat-lease expiry
                     (`TaskServer(lease_timeout=..., clock=ManualClock())`).
  * task failure   — `fail_task(name)` / `fail_rate(p)`: the task reports
                     Complete(ok=False) and poisons transitive successors.
                     `fail_first_k(k)` makes failures *transient*: only the
                     first k execution attempts of each affected task fail,
                     so a `RetryPolicy(max_attempts > k)` deterministically
                     recovers — the retry paths' test harness.
  * stragglers     — `stragglers(sigma)`: per-(task, worker) Gaussian
                     *virtual* delay, recorded in the trace but never slept.
                     Feeds the mpi-list Gumbel sync-gap model
                     (`METGModel.mpilist_metg(P, per_rank_sigma=sigma)`).
"""
from __future__ import annotations

import random
from typing import Optional


class FaultPlan:
    def __init__(self, seed: int = 0):
        self.seed = seed
        self._kills: dict[str, int] = {}       # worker -> after_steals
        self._silent: set[str] = set()
        self._fail: set[str] = set()
        self._fail_rate: float = 0.0
        self._sigma: float = 0.0
        self._first_k: int = 0                 # transient: fail attempts < k
        self._first_k_rate: float = 1.0
        self._first_k_tasks: Optional[set] = None

    # -------------------------------------------------------- configure
    def kill_worker(self, worker: str, after_steals: int = 1,
                    silent: bool = False) -> "FaultPlan":
        self._kills[worker] = after_steals
        if silent:
            self._silent.add(worker)
        return self

    def fail_task(self, name: str) -> "FaultPlan":
        self._fail.add(name)
        return self

    def fail_rate(self, p: float) -> "FaultPlan":
        self._fail_rate = p
        return self

    def fail_first_k(self, k: int, rate: float = 1.0,
                     tasks: Optional[list] = None) -> "FaultPlan":
        """Transient failures: each affected task's first `k` execution
        attempts fail, then it succeeds.  `rate` < 1 selects the affected
        subset by seeded draw (keyed by task name); `tasks` restricts
        injection to an explicit set.  Pairs with `RetryPolicy`: with
        `max_attempts > k` the workload deterministically completes, with
        `max_attempts <= k` the affected tasks deterministically poison."""
        self._first_k = int(k)
        self._first_k_rate = float(rate)
        self._first_k_tasks = set(tasks) if tasks is not None else None
        return self

    def stragglers(self, sigma: float) -> "FaultPlan":
        self._sigma = sigma
        return self

    # ------------------------------------------------------ engine hooks
    def _rng(self, *key) -> random.Random:
        return random.Random(f"{self.seed}:" + ":".join(map(str, key)))

    def should_die(self, worker: str, stolen_so_far: int) -> bool:
        k = self._kills.get(worker)
        return k is not None and stolen_so_far >= k

    def dies_silently(self, worker: str) -> bool:
        return worker in self._silent

    def force_fail(self, task: str, worker: Optional[str] = None,
                   attempt: int = 0) -> bool:
        """Should this execution of `task` fail?  `attempt` is how many
        times the task has already run (0 on first execution) — the
        engine's retry machinery threads it through so `fail_first_k`
        injection stops once a task has burned its transient budget."""
        if task in self._fail:
            return True
        if self._fail_rate > 0.0 \
                and self._rng("fail", task).random() < self._fail_rate:
            return True
        if self._first_k > 0 and attempt < self._first_k:
            if self._first_k_tasks is not None:
                return task in self._first_k_tasks
            if self._first_k_rate >= 1.0:
                return True
            return self._rng("first_k", task).random() < self._first_k_rate
        return False

    def delay_s(self, task: str, worker: Optional[str] = None) -> float:
        """Virtual straggler jitter for this task (seconds; may be
        negative — it's jitter about the mean, and only max-min gaps
        matter for the Gumbel sync-gap law).  Keyed by task name only, so
        the draw is independent of which worker runs it or in what
        order."""
        if self._sigma <= 0.0:
            return 0.0
        return self._rng("straggle", task).gauss(0.0, self._sigma)
