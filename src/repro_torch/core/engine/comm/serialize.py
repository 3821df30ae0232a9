"""Serialization at the process boundary (`transport="proc"`), the port's
copy of the JAX package's `repro.core.engine.comm.serialize`.

The in-process transports pass callables and values by reference; a
worker process needs them by value.  cloudpickle (pickle fallback)
carries lambdas, closures, and `__main__` functions; payloads are
base64-encoded to str so both wire codecs (msgpack and the JSON
fallback) ship them unchanged inside the Table-2 frames.

The one rule this module enforces: an unpicklable callable or argument
must fail LOUDLY at the submit boundary (`SerializationError`, naming
the task) — never opaquely inside a worker process.
"""
from __future__ import annotations

import base64
import pickle
import threading
from typing import Optional

try:
    import cloudpickle as _pickler
except ImportError:    # no cloudpickle: plain pickle (named callables only)
    _pickler = pickle


class SerializationError(TypeError):
    """A callable / argument / result cannot cross the process boundary."""


class Ref:
    """Placeholder for a dependency's value in a serialized call: the
    worker resolves it from its local value cache, a peer fetch from the
    producing worker's data listener, or a Fetch round-trip to the hub
    before invoking the fn."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"Ref({self.name!r})"


class RemoteValue:
    """A lazy handle for a result whose payload stayed in its producing
    worker's local store (the peer-to-peer data plane): the engine saw
    only the location, not the bytes.  `get()` materializes on first use
    — hub value store first, then a peer fetch from the producer — and
    caches; `Future.result()` calls it transparently, so code only sees
    a handle when it inspects a `TaskResult.value` directly.  Engine-
    side only: a RemoteValue never crosses the wire."""

    __slots__ = ("task", "nbytes", "_fetch", "_value", "_have", "_lock")

    def __init__(self, task: str, nbytes: int, fetch):
        self.task = task
        self.nbytes = int(nbytes)
        self._fetch = fetch              # engine's materializer (task)->val
        self._value = None
        self._have = False
        self._lock = threading.Lock()

    def get(self):
        """Materialize (and cache) the value; raises KeyError when the
        payload is unrecoverable (producer dead AND never replicated —
        the engine's recompute path prevents this for live sessions)."""
        with self._lock:
            if not self._have:
                self._value = self._fetch(self.task)
                self._have = True
                self._fetch = None       # drop the engine edge once cached
            return self._value

    @property
    def resolved(self) -> bool:
        return self._have

    def __repr__(self):
        state = "cached" if self._have else f"{self.nbytes}B remote"
        return f"RemoteValue({self.task!r}, {state})"


def dumps(obj, *, what: str = "object") -> str:
    """Pickle `obj` to a base64 str, or raise `SerializationError`
    describing `what` failed (and why) instead of a worker-side hang."""
    try:
        return base64.b64encode(_pickler.dumps(obj)).decode("ascii")
    except Exception as e:  # noqa: BLE001 — any pickling failure
        raise SerializationError(
            f"{what} cannot be serialized for transport='proc': {e!r}. "
            "Worker processes receive tasks by value (cloudpickle); "
            "closures over locks/sockets/files cannot cross the process "
            "boundary — pass plain data, or use an in-process transport."
        ) from e


def loads(payload: str):
    return _pickler.loads(base64.b64decode(payload.encode("ascii")))


def dumps_call(fn, args=(), kwargs=None, *, task: Optional[str] = None) -> str:
    """Serialize `(fn, args, kwargs)` for a worker process, naming the
    task in the error so a failed submit points at its cause."""
    label = f"task {task!r}" if task else "submitted call"
    fname = getattr(fn, "__name__", None)
    if fname and fname != "<lambda>":
        label += f" ({fname})"
    return dumps((fn, tuple(args), dict(kwargs or {})), what=label)


def loads_call(payload: str):
    """-> (fn, args, kwargs) as packed by `dumps_call`."""
    return loads(payload)
