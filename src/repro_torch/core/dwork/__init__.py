"""dwork: client/server bag-of-tasks with dependencies (Rogers 2021, §2.2),
the port's copy of the JAX package's `repro.core.dwork`.

Minimal API (paper Table 2): Create / Steal / Complete / Transfer / Exit,
plus `Steal n` batching.  The server keeps exactly two tables — join
counters + successors, and task metadata — and a double-ended ready queue
(FIFO for steals, LIFO for re-inserted tasks).  Wire format and on-disk
state are the JAX package's, so either side's clients, servers and saved
files work with the other's.  `ShardedHub` (the paper's §6 sharded
servers) fronts several TaskServers; the unified engine and the futures
client drive it (`repro_torch.core.engine`, `repro_torch.client`), and
`run_pool` dispatches a server's tasks through them.  The forwarding tree
(`Forwarder`) is not ported yet.
"""
from repro_torch.core.dwork.api import (Complete, CompleteSteal, Create, Exit,
                                        ExitResp, NotFound, Steal, TaskMsg,
                                        Transfer)
from repro_torch.core.dwork.server import TaskServer
from repro_torch.core.dwork.client import (Client, InProcTransport, TCPServer,
                                           TCPTransport)
from repro_torch.core.dwork.overlap import OverlapClient
from repro_torch.core.dwork.pool import run_pool
from repro_torch.core.dwork.sharded import ShardedHub

__all__ = ["Create", "Steal", "Complete", "CompleteSteal", "Transfer",
           "Exit", "TaskMsg", "NotFound", "ExitResp", "TaskServer", "Client",
           "InProcTransport", "TCPServer", "TCPTransport", "OverlapClient",
           "ShardedHub", "run_pool"]
