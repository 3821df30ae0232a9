"""Comm subsystem: pluggable connectors/listeners + transport families,
the port's copy of the JAX package's `repro.core.engine.comm`.

`transport="proc"` lives here: real worker processes speaking the
Table-2 frame protocol over sockets (see
`repro_torch.core.engine.comm.proc`), joinable from other hosts with

    python -m repro_torch.core.engine.comm.worker --connect HOST:PORT
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
