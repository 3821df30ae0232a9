"""mpi-list: bulk-synchronous distributed lists (Rogers 2021, §2.3), the
port's copy of the JAX package's `repro.core.mpi_list`.

A `Context` holds the communicator; a `DFM` (distributed free monoid) is an
ordered global list with a contiguous ascending block per rank:
rank p of P stores the subsequence starting at ``p*(N//P) + min(p, N%P)``.

Three backends:
  * in-process rank simulation (`Context(n_ranks)`) — semantics-exact SPMD,
    used by the data pipeline, tests, and METG benchmarks;
  * engine-backed multi-rank mode (`Context(n_ranks, engine_workers=W)`) —
    the map-family bulk steps (map / flatMap / filter) dispatch one task
    per rank on the unified engine pool (`repro_torch.core.engine`), with
    seeded straggler injection feeding the Gumbel sync-gap law
    (`Context.straggler_crosscheck`); reductions and data movement
    (reduce / scan / repartition / group) stay in-process;
  * device bridge (`repro_torch.core.mpi_list.mesh_ops`) — the same bulk
    ops on tensors on one torch device (map -> vmap, reduce -> pairwise
    tree, scan -> log-step prefix, group -> stable sort + gather), where
    the JAX package lowers them onto a jax mesh's data axis.  A layout
    over several cards waits for `torch.distributed` sharding.
"""
from repro_torch.core.mpi_list.context import DFM, Context, partition_bounds

__all__ = ["Context", "DFM", "partition_bounds"]
