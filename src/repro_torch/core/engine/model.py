"""Engine data model: tasks, results, and wall-clock-stamped trace events;
the port's copy of the JAX package's `repro.core.engine.model`.

Lifecycle (mirrors the paper's Fig. 2 message protocol, generalized to all
three schedulers):

    created  -> ready -> stolen -> run_start -> run_end -> completed
                  ^                                     -> failed
                  |________ requeued (Exit / lease expiry / Transfer) __|

Mapping to Fig. 2 / Table 2 messages:
    created   <- Create(task, deps)        (dwork) / build_graph (pmake)
    stolen    <- Steal -> TaskMsg          (dwork) / greedy launch (pmake)
                                           / rank-block dispatch (mpi-list)
    completed <- Complete(worker, task, ok=True)
    failed    <- Complete(ok=False)        (poisons transitive successors)
    requeued  <- Exit(worker) recycle, lease-timeout reap, or Transfer
"""
from __future__ import annotations

import itertools
import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

# ---------------------------------------------------------------- events
CREATED = "created"
READY = "ready"
STOLEN = "stolen"
RUN_START = "run_start"
RUN_END = "run_end"
COMPLETED = "completed"
FAILED = "failed"
REQUEUED = "requeued"
RETRIED = "retried"             # transient failure re-enqueued (RetryPolicy)
CANCELLED = "cancelled"         # client cancel before the task was stolen
WORKER_DEAD = "worker_dead"
RPC = "rpc"                     # one scheduler round-trip (the paper's RTT)
XFER = "xfer"                   # one dependency-value transfer (extra:
                                # path="peer"|"hub", n=bytes, dt=seconds)

# serving-layer events (core.serving): one *request* may ride a
# coalesced batch task, so its lifecycle is traced separately from tasks
REQ_ENQUEUED = "req_enqueued"   # admitted to the frontend queue
REQ_DONE = "req_done"           # response delivered (extra: latency_s, ok)
REQ_REJECTED = "req_rejected"   # bounced by admission backpressure
REQ_TIMEOUT = "req_timeout"     # queued past its deadline (never dispatched)
BATCH_FORMED = "batch_formed"   # requests coalesced into one engine task

# a named stretch of the program (`tracing.span`): stamped at its end,
# extra: name, t0 (its start), parent (the enclosing span's name or None)
# and the caller's own keys
SPAN = "span"

TERMINAL = (COMPLETED, FAILED)


class WorkerCrash(Exception):
    """Raise from inside an `execute` callback to simulate (or propagate) a
    fatal worker failure.  The engine marks the raising worker dead,
    announces its Exit so the in-flight task and everything it still holds
    is requeued (never marked failed), and keeps dispatching on the
    surviving workers — the paper's node-failure recovery, triggerable from
    application code (runtime.elastic uses it for crash drills)."""


class TraceEvent:
    """One lifecycle/rpc event.  A plain slotted class (not a dataclass):
    it is allocated 4-5 times per task on the hot path, and the per-event
    dict + generated __init__ of a dataclass are measurable there."""

    __slots__ = ("t", "event", "task", "worker", "extra")

    def __init__(self, t: float, event: str, task: Optional[str] = None,
                 worker: Optional[str] = None, extra: Optional[dict] = None):
        self.t = t
        self.event = event
        self.task = task
        self.worker = worker
        self.extra = extra if extra is not None else {}

    def __repr__(self):
        return (f"TraceEvent(t={self.t!r}, event={self.event!r}, "
                f"task={self.task!r}, worker={self.worker!r}, "
                f"extra={self.extra!r})")


@dataclass(frozen=True)
class RetryPolicy:
    """Transient-failure handling for task executions.

    A failed execution (raise, ok=False, or an injected fault) is
    re-enqueued with seeded-jitter exponential backoff until it has run
    `max_attempts` times; only exhaustion marks the task failed and
    poisons its successors.  `retry_on` (substrings matched against the
    error repr) limits which failures count as transient — anything else
    fails immediately.  `WorkerCrash` is never retried: a dying worker's
    assignment is requeued by the Exit/lease machinery, not by policy.

    Backoff for attempt k (1-based) is `backoff * 2**(k-1)` scaled by a
    seeded uniform jitter in [1, 1+jitter] — keyed by (seed, task,
    attempt), so the delay is a pure function of the plan, independent
    of execution order (the same determinism contract as `FaultPlan`).
    Retried tasks keep their scheduler-side assignment, so a retry costs
    no extra protocol round-trip — only the backoff delay, which trades
    against METG: keep `backoff` well under the task duration times
    `max_attempts` or retries dominate the overhead budget (see
    docs/robustness.md)."""
    max_attempts: int = 3
    backoff: float = 0.0
    jitter: float = 0.5
    seed: int = 0
    retry_on: Optional[tuple] = None

    def should_retry(self, attempt: int, error: Optional[str] = None) -> bool:
        """Is a re-run allowed after `attempt` executions (1-based) ended
        with `error`?"""
        if attempt >= self.max_attempts:
            return False
        if self.retry_on is None:
            return True
        err = error or ""
        return any(pat in err for pat in self.retry_on)

    def delay_s(self, task: str, attempt: int) -> float:
        """Seeded-jitter backoff before re-run number `attempt + 1`."""
        if self.backoff <= 0.0:
            return 0.0
        base = self.backoff * (2.0 ** max(attempt - 1, 0))
        if self.jitter <= 0.0:
            return base
        u = random.Random(f"{self.seed}:retry:{task}:{attempt}").random()
        return base * (1.0 + self.jitter * u)


@dataclass
class EngineTask:
    """A unit of work submitted to the engine.

    `fn` is an optional zero-arg callable producing the task's value (used
    by the mpi-list adapter and examples); schedulers that execute by name
    (dwork's `execute(name, meta)`, pmake's script runner) leave it None.
    `slots` is the number of pool slots the task occupies while running
    (pmake: nodes, `nrs`); `priority` is greedy-highest-first (pmake EFT);
    `retry` overrides the engine-wide `RetryPolicy` for this task.
    """
    name: str
    fn: Optional[Callable[[], Any]] = None
    deps: tuple = ()
    meta: dict = field(default_factory=dict)
    slots: int = 1
    priority: float = 0.0
    retry: Optional[RetryPolicy] = None


@dataclass(slots=True)
class TaskResult:
    task: str
    ok: bool
    worker: str
    t_start: float = 0.0        # real clock (perf_counter) run span
    t_end: float = 0.0
    value: Any = None
    error: Optional[str] = None
    virtual_s: float = 0.0      # injected straggler time (never slept)
    crashed: bool = False       # WorkerCrash: requeue, don't record/fail

    @property
    def duration_s(self) -> float:
        return (self.t_end - self.t_start) + self.virtual_s


class ManualClock:
    """Deterministic clock for tests: advances `tick` seconds per call plus
    whatever `advance()` adds.  Using it for both the trace recorder and the
    task server's lease clock makes heartbeat/lease expiry a pure function
    of the number of scheduler operations — no wall-clock dependence."""

    def __init__(self, start: float = 0.0, tick: float = 0.0):
        self.now = start
        self.tick = tick

    def __call__(self) -> float:
        self.now += self.tick
        return self.now

    def advance(self, dt: float) -> float:
        self.now += dt
        return self.now


_seq = itertools.count()


def next_seq() -> int:
    """Monotonic tie-breaker for priority scheduling (stable FIFO)."""
    return next(_seq)


# the default trace clock IS perf_counter — no wrapper frame on the hot path
real_clock = time.perf_counter
