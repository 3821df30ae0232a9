"""repro_torch.core — the port's copy of the paper's schedulers, so far:

  dwork    client/server bag-of-tasks with dependencies, and the sharded
           hub                                           (paper §2.2, §6)
  engine   the unified worker pool all three schedulers run on: inproc
           and thread transports, faults, leases, journal, tracing
  serving  the METG-batching request frontend over a resident engine
  metg     minimum-effective-task-granularity scaling laws (§3-§6)

The futures front door over the engine is `repro_torch.client`.  pmake,
mpi-list, the forwarding tree, worker processes and core/obs are not
ported yet.
"""
