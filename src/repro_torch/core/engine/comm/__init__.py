"""Comm subsystem: pluggable connectors/listeners + transport families,
the port's copy of the JAX package's `repro.core.engine.comm`.

The registry names the JAX package's four transports.  "inproc" and
"thread" run; "tree" and "proc" (worker processes over sockets, the JAX
package's `comm/proc.py` and `comm/worker.py`) raise `NotImplementedError`
until they are ported (ROADMAP.md Queue 1 items 4d and 4g).
"""
from repro_torch.core.engine.comm.core import (Comm, Connector, Listener,
                                               TransportFamily, connect,
                                               family, listen,
                                               register_connector,
                                               register_listener,
                                               register_transport,
                                               transport_names)
from repro_torch.core.engine.comm.serialize import (Ref, SerializationError,
                                                    dumps, dumps_call, loads,
                                                    loads_call)

__all__ = [
    "Comm", "Connector", "Listener", "TransportFamily",
    "connect", "listen", "family", "transport_names",
    "register_connector", "register_listener", "register_transport",
    "Ref", "SerializationError", "dumps", "dumps_call", "loads",
    "loads_call",
]
