"""dwork wire API (paper Table 2), the port's copy of the JAX package's
`repro.core.dwork.api`: the same messages, tags and bytes, so a JAX client
talks to a port server and the reverse.

Queries:  Create(task, deps) | Steal(worker, n) | Complete(worker, task)
          | CompleteSteal(worker, done, n) | Transfer(worker, task, new_deps)
          | Exit(worker) | Cancel(task)
Responses: TaskMsg(tasks) | NotFound | ExitResp

`CompleteSteal` is the Fig. 2 batch-then-drain rhythm collapsed into one
round-trip: a worker reports every task it finished since its last call
and (optionally) steals its next batch in the same message, so `steal_n`
amortizes both directions of the protocol.  With `n=0` it degenerates to
a batched Complete.

Workers are strings; tasks are (name, meta-dict) — the protobuf analog.
Serialization is msgpack where it is installed, else JSON, with a one-byte
tag; both ends of a connection must make the same choice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

try:
    import msgpack

    def _dumps(obj) -> bytes:
        return msgpack.packb(obj, use_bin_type=True)

    def _loads(b: bytes):
        return msgpack.unpackb(b, raw=False)
except ImportError:    # no msgpack: JSON on the wire
    import json

    def _dumps(obj) -> bytes:
        return json.dumps(obj).encode()

    def _loads(b: bytes):
        return json.loads(b.decode())


@dataclass
class Create:
    task: str
    deps: list = field(default_factory=list)
    meta: dict = field(default_factory=dict)
    hold: bool = False        # +1 join count, released via Release (sharding)


@dataclass
class Release:
    task: str


@dataclass
class Steal:
    worker: str
    n: int = 1                      # paper §5: "Steal n" batching


@dataclass
class Complete:
    worker: str
    task: str
    ok: bool = True


@dataclass
class CompleteSteal:
    """Piggyback a batch of completions onto the next steal (one RTT for
    both protocol directions).  `done` is [(task, ok), ...]; `n=0` means
    complete-only (the response is ExitResp, not a steal result)."""
    worker: str
    done: list = field(default_factory=list)
    n: int = 0


@dataclass
class Transfer:
    """Replace a running task back into the queue with NEW dependencies
    (paper: dynamic task graphs; cycles via Transfer are the documented
    user-error deadlock)."""
    worker: str
    task: str
    new_deps: list = field(default_factory=list)


@dataclass
class Cancel:
    """Withdraw a task that no worker holds yet (framework extension for
    the futures client).  Succeeds only while the task is unleased and
    non-terminal; the server then poisons it like a failure so transitive
    successors can never run.  Response: ExitResp on success, NotFound if
    the task is already stolen/terminal/unknown."""
    task: str


@dataclass
class Exit:
    worker: str


@dataclass
class TaskMsg:
    tasks: list                     # [(name, meta), ...]


@dataclass
class NotFound:
    pass


@dataclass
class ExitResp:
    pass


@dataclass
class Stats:
    pass


# ------------------------------------------------- proc-transport verbs
# (the JAX package's engine `comm`, not ported yet): spoken between a
# worker PROCESS and the engine's front door, never by the TaskServer
# itself — the front door
# strips them (and the extended CompleteSteal `done` entries, which may
# carry a third per-task element {"v": value, "e": error, "d": duration,
# "n": nbytes, "x": xfer stats, "as": store-as alias}) down to the plain
# Table-2 protocol before forwarding.  Results larger than the inline
# threshold stay in the producing worker's local store ("n" instead of
# "v"); the hub tracks their LOCATION and answers Fetch with a LocMsg
# redirect so dependents pull peer-to-peer.  Spill pushes an evicted (or
# exit-flushed) value back to the hub so it survives the producer.

# error prefix a worker uses to report a dependency value it could not
# obtain from either its producer or the hub (producer SIGKILLed before
# replication): the front door intercepts these instead of failing the
# task, and the engine recomputes the missing value
XFER_LOST_PREFIX = "__xfer_lost__:"


@dataclass
class Hello:
    """Worker-process handshake.  An empty `worker` asks the engine to
    assign an id (multi-host join).  `data_addr` advertises the worker's
    peer-fetch listener (`tcp://host:port`; empty = no data plane)."""
    worker: str = ""
    pid: int = 0
    host: str = ""
    data_addr: str = ""


@dataclass
class HelloResp:
    """Handshake reply: the worker's id plus its run configuration —
    steal batch size, heartbeat cadence, data-plane thresholds
    (`inline_bytes`: results at most this many payload bytes inline into
    CompleteSteal; `spill_bytes`: the worker-local store's LRU byte
    budget), and (optionally) the engine's execute callback as a
    cloudpickle payload."""
    worker: str = ""
    steal_n: int = 1
    resident: bool = False
    pass_worker: bool = False
    heartbeat_s: float = 0.5
    execute: Optional[str] = None
    inline_bytes: int = 65536
    spill_bytes: int = 67108864


@dataclass
class Heartbeat:
    """Liveness beacon (response: ExitResp).  A worker whose heartbeats
    go stale past the engine's grace window is declared crashed and its
    in-flight work requeues."""
    worker: str


@dataclass
class Fetch:
    """Ask for a completed task's serialized value (dependency values a
    worker doesn't hold locally).  Response: ValueMsg | NotFound."""
    task: str


@dataclass
class ValueMsg:
    task: str
    payload: str = ""


@dataclass
class LocMsg:
    """Fetch redirect: the hub doesn't hold the value, but knows the
    worker that does — dial `addr` (a worker's data listener) and Fetch
    there.  `nbytes` is the serialized payload size (attribution)."""
    task: str
    addr: str = ""
    worker: str = ""
    nbytes: int = 0


@dataclass
class Spill:
    """Push a locally-stored result's payload to the hub: LRU eviction
    under the worker's byte budget, or the exit flush that replicates
    every still-unspilled owned value before a clean goodbye.  Response:
    ExitResp (accepted) | NotFound (the hub no longer tracks the task —
    pruned; the payload is dropped)."""
    worker: str
    task: str
    payload: str = ""


_TAGS = {"Create": Create, "Steal": Steal, "Complete": Complete,
         "CompleteSteal": CompleteSteal, "Transfer": Transfer, "Exit": Exit,
         "TaskMsg": TaskMsg, "NotFound": NotFound, "ExitResp": ExitResp,
         "Stats": Stats, "Release": Release, "Cancel": Cancel,
         "Hello": Hello, "HelloResp": HelloResp, "Heartbeat": Heartbeat,
         "Fetch": Fetch, "ValueMsg": ValueMsg, "LocMsg": LocMsg,
         "Spill": Spill}


def encode(msg) -> bytes:
    return _dumps([type(msg).__name__, msg.__dict__])


def decode(b: bytes):
    tag, kw = _loads(b)
    if tag == "StatsResp":
        return kw
    return _TAGS[tag](**kw)


def encode_stats(d: dict) -> bytes:
    return _dumps(["StatsResp", d])
