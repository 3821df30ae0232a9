"""repro_torch.core — the port's copy of the paper's schedulers:

  pmake     file-based make-like workflow scheduler, EFT priorities
                                                          (paper §2.1)
  dwork     client/server bag-of-tasks with dependencies, the sharded
            hub and `run_pool`                            (paper §2.2, §6)
  mpi_list  bulk-synchronous distributed lists (DFM), engine-backed
            rank maps, and the DFM bridge on a torch device (paper §2.3)
  engine    the unified worker pool all three schedulers run on: inproc,
            thread and forwarding-tree transports, faults, leases,
            journal, tracing
  obs       live stats server, Prometheus metrics, Chrome-trace export
            and the critical-path `explain`
  serving   the METG-batching request frontend over a resident engine
  metg      minimum-effective-task-granularity scaling laws (§3-§6)

The futures front door over the engine is `repro_torch.client`.  The
worker processes (the "proc" transport) are not ported yet.
"""
