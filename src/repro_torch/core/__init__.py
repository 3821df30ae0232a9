"""repro_torch.core — the port's copy of the paper's schedulers, so far:

  dwork  client/server bag-of-tasks with dependencies   (paper §2.2)
  metg   minimum-effective-task-granularity scaling laws (§3-§6)

pmake, mpi-list and the engine are not ported yet.
"""
