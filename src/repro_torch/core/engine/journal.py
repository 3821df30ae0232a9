"""Write-ahead journal: durable Table-2 state transitions for the engine;
the port's copy of the JAX package's `repro.core.engine.journal`, writing
the same files, so either engine recovers from the other's journal.

The unified engine keeps its task universe in memory (TaskServer /
ShardedHub tables); kill the process mid-campaign and every non-pmake
workload loses it.  This module makes the control plane durable the way
databases do — not by snapshotting the whole state on every change, but
by appending each state *transition* to an fsync-batched log and
compacting periodically:

    <dir>/checkpoint.json      compacted state (tmp file + atomic
                               os.replace — the same crash-safe publish
                               idiom as checkpoint/ckpt.py)
    <dir>/wal-<n>.jsonl        append-only segment of records since the
                               checkpoint (JSON lines; a torn final line
                               from a mid-write crash is tolerated)

Record shapes (compact JSON arrays, one per line):

    ["c",  name, [deps...], {meta}]    Create
    ["ok", name]                       Complete(ok=True)
    ["f",  name, error]                Complete(ok=False) / poison
    ["x",  name]                       Cancel
    ["rq", n, via]                     n tasks requeued (exit / lease)

`Journal.replay(dir)` folds checkpoint + segments into a `JournalState`;
`Engine.recover(journal_dir)` uses it to rebuild the task tables —
terminal names seed the exactly-once accounting (they never re-run,
never re-fire `on_result`) and every created-but-not-terminal task is
re-submitted ready, which re-marks leased-but-unfinished work from the
crashed run as stealable (the journal records no leases: an assignment
that never completed is work to redo, exactly like the dwork server's
save/load contract).

Durability granularity is the fsync batch (`sync_every` records, default
64): a crash loses at most the tail of unsynced records, which replays
as "not terminal" and re-runs — at-least-once execution, exactly-once
terminal accounting.  Appends are deduplicated by name (a terminal
record for an already-terminal name, or a duplicate create, writes
nothing), so recovery re-submission is idempotent and the log cannot
grow from replays.

Thread safety: one lock around append/sync/checkpoint.  The engine
journals from its dispatch thread (and `submit()` from client threads in
batch mode), so contention is the same short-hold pattern as the trace
ring.
"""
from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

CHECKPOINT = "checkpoint.json"
SEGMENT_FMT = "wal-{:06d}.jsonl"


@dataclass
class JournalState:
    """Folded journal contents: the recoverable control-plane state."""
    created: dict = field(default_factory=dict)   # name -> (deps, meta)
    completed: set = field(default_factory=set)
    failed: dict = field(default_factory=dict)    # name -> error
    cancelled: set = field(default_factory=set)
    requeues: int = 0
    torn_lines: int = 0          # undecodable tails skipped during replay

    def terminal(self) -> set:
        return self.completed | set(self.failed) | self.cancelled

    def pending(self) -> list:
        """(name, deps, meta) for every created-but-not-terminal task,
        in original creation order (producers before dependents — the
        order submissions arrived in)."""
        term = self.terminal()
        return [(n, deps, meta) for n, (deps, meta) in self.created.items()
                if n not in term]

    def summary(self) -> dict:
        return {
            "created": len(self.created), "completed": len(self.completed),
            "failed": len(self.failed), "cancelled": len(self.cancelled),
            "pending": len(self.pending()), "requeues": self.requeues,
            "torn_lines": self.torn_lines,
        }


def _apply(state: JournalState, rec: list):
    kind = rec[0]
    if kind == "c":
        state.created.setdefault(rec[1], (tuple(rec[2]), rec[3]))
    elif kind == "ok":
        state.completed.add(rec[1])
    elif kind == "f":
        state.failed.setdefault(rec[1], rec[2])
    elif kind == "x":
        state.cancelled.add(rec[1])
    elif kind == "rq":
        state.requeues += int(rec[1])
    # unknown kinds are skipped: a newer writer's records must not brick
    # an older reader's recovery


class Journal:
    """Append-side handle over one journal directory.

        j = Journal(dir)                      # creates or re-opens
        eng = Engine(resident=True, journal=j)

    Opening an existing directory replays it first (seeding the dedup
    state) and continues appending to the latest segment — the handle
    `Engine.recover` re-attaches after a crash.
    """

    def __init__(self, path, *, sync_every: int = 64,
                 checkpoint_every: int = 10000):
        self.dir = Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.sync_every = max(int(sync_every), 1)
        self.checkpoint_every = max(int(checkpoint_every), 0)
        self.bytes_written = 0        # total appended (obs counter)
        self.n_records = 0
        self.n_syncs = 0
        self.n_checkpoints = 0
        self._lock = threading.Lock()
        self._pending = 0             # appended since the last fsync
        self._since_ckpt = 0          # appended since the last checkpoint
        self._state = self.replay(self.dir)      # dedup + compaction state
        self._seg = self._latest_segment()
        self._fh = open(self.dir / SEGMENT_FMT.format(self._seg), "a",
                        encoding="utf-8")

    # ------------------------------------------------------------- append
    def append_create(self, name: str, deps=(), meta=None):
        with self._lock:
            if name in self._state.created:
                return                       # recovery re-submit: no-op
            deps = tuple(deps)
            meta = dict(meta or {})
            self._state.created[name] = (deps, meta)
            self._append(["c", name, list(deps), meta])

    def append_terminal(self, name: str, ok: bool,
                        error: Optional[str] = None):
        with self._lock:
            st = self._state
            if name in st.completed or name in st.failed \
                    or name in st.cancelled:
                return                       # terminal is exactly-once
            if ok:
                st.completed.add(name)
                self._append(["ok", name])
            else:
                st.failed[name] = error
                self._append(["f", name, error])

    def append_cancel(self, name: str):
        with self._lock:
            st = self._state
            if name in st.completed or name in st.failed \
                    or name in st.cancelled:
                return
            st.cancelled.add(name)
            self._append(["x", name])

    def append_requeue(self, n: int, via: str):
        with self._lock:
            self._state.requeues += int(n)
            self._append(["rq", int(n), via])

    def _append(self, rec: list):
        # caller holds the lock
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        self._fh.write(line)
        self.bytes_written += len(line)
        self.n_records += 1
        self._pending += 1
        self._since_ckpt += 1
        if self.checkpoint_every and self._since_ckpt >= self.checkpoint_every:
            self._checkpoint_locked()
        elif self._pending >= self.sync_every:
            self._sync_locked()

    # ------------------------------------------------------------ durable
    def sync(self):
        """Flush + fsync everything appended so far (the engine calls
        this at drain/shutdown so a clean stop is fully durable)."""
        with self._lock:
            self._sync_locked()

    def _sync_locked(self):
        if self._pending == 0:
            return
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._pending = 0
        self.n_syncs += 1

    def checkpoint(self):
        """Compact: publish the folded state as checkpoint.json (tmp file
        + atomic rename), rotate to a fresh WAL segment, delete the
        superseded ones.  Terminal tasks keep only their name/error — the
        create records they accumulated are dropped, which is the
        compaction."""
        with self._lock:
            self._checkpoint_locked()

    def _checkpoint_locked(self):
        self._sync_locked()
        st = self._state
        next_seg = self._seg + 1
        doc = {
            "seg": next_seg,
            "created": [[n, list(deps), meta]
                        for n, (deps, meta) in st.created.items()
                        if n not in st.completed and n not in st.failed
                        and n not in st.cancelled],
            "completed": sorted(st.completed),
            "failed": dict(st.failed),
            "cancelled": sorted(st.cancelled),
            "requeues": st.requeues,
        }
        tmp = self.dir / (CHECKPOINT + ".tmp")
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, separators=(",", ":"))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.dir / CHECKPOINT)   # atomic publish
        # compact in memory too: the dropped create records are exactly
        # the ones the published checkpoint no longer carries
        for n in list(st.created):
            if n in st.completed or n in st.failed or n in st.cancelled:
                del st.created[n]
        self._fh.close()
        old_seg, self._seg = self._seg, next_seg
        self._fh = open(self.dir / SEGMENT_FMT.format(next_seg), "a",
                        encoding="utf-8")
        for p in self.dir.glob("wal-*.jsonl"):
            try:
                if int(p.stem.split("-")[1]) <= old_seg:
                    p.unlink()
            except (ValueError, OSError):
                pass
        self._since_ckpt = 0
        self.n_checkpoints += 1

    def close(self):
        with self._lock:
            if self._fh.closed:
                return
            self._sync_locked()
            self._fh.close()

    # ------------------------------------------------------------- replay
    def _latest_segment(self) -> int:
        segs = []
        for p in self.dir.glob("wal-*.jsonl"):
            try:
                segs.append(int(p.stem.split("-")[1]))
            except ValueError:
                pass
        if segs:
            return max(segs)
        ckpt = self.dir / CHECKPOINT
        if ckpt.exists():
            try:
                return int(json.loads(ckpt.read_text()).get("seg", 0))
            except (ValueError, OSError):
                pass
        return 0

    @staticmethod
    def replay(path) -> JournalState:
        """Fold checkpoint + WAL segments into a `JournalState`.  Missing
        files mean an empty journal; an undecodable line (a torn tail
        from a mid-write crash) ends that segment's replay and is
        counted in `torn_lines`."""
        d = Path(path)
        state = JournalState()
        first_seg = 0
        ckpt = d / CHECKPOINT
        if ckpt.exists():
            doc = json.loads(ckpt.read_text())
            first_seg = int(doc.get("seg", 0))
            for n, deps, meta in doc.get("created", []):
                state.created[n] = (tuple(deps), meta)
            state.completed.update(doc.get("completed", []))
            state.failed.update(doc.get("failed", {}))
            state.cancelled.update(doc.get("cancelled", []))
            state.requeues = int(doc.get("requeues", 0))
        segs = []
        for p in d.glob("wal-*.jsonl"):
            try:
                n = int(p.stem.split("-")[1])
            except ValueError:
                continue
            if n >= first_seg:
                segs.append((n, p))
        for _, p in sorted(segs):
            with open(p, encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        state.torn_lines += 1
                        break        # a torn line ends the segment
                    _apply(state, rec)
        return state

    # ---------------------------------------------------------------- obs
    def stats(self) -> dict:
        with self._lock:
            return {
                "dir": str(self.dir), "segment": self._seg,
                "bytes_written": self.bytes_written,
                "n_records": self.n_records, "n_syncs": self.n_syncs,
                "n_checkpoints": self.n_checkpoints,
                **self._state.summary(),
            }

    def __repr__(self):
        return (f"Journal({str(self.dir)!r}, seg={self._seg}, "
                f"records={self.n_records}, bytes={self.bytes_written})")
