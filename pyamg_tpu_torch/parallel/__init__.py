"""Row-sharded solves over the ranks of a ``torch.distributed`` group
(counterpart of ``pyamg_tpu/parallel``).

The JAX package splits each large level's rows over a device mesh and
lets GSPMD insert the collectives.  Here one rank is one process with its
card: the caller starts the processes and calls
``torch.distributed.init_process_group``, ``make_row_mesh`` names the
ranks, and ``shard_hierarchy`` splits a hierarchy's large levels by rows.
The collectives are written where GSPMD put them: an all-gather (or a
halo exchange, ``spmv="halo"``) before a product on a sharded level, and
one all-reduce for each inner product of a Krylov loop.  The coarse tail
is whole on every rank.

Not ported yet (the distributed setup): ``distributed_sa_setup``,
``distributed_classical_setup``, ``dist_stencil_grid``,
``dist_from_scipy``, ``DistHierarchy`` and ``DistLevel``.
"""

from pyamg_tpu_torch.parallel.partition import (
    RowMesh, ShardedELL, make_row_mesh, pad_matrix_rows, replicate,
    shard_hierarchy, shard_matrix, shard_vector)
from pyamg_tpu_torch.parallel.halo import (
    HaloELL, build_halo, build_halo_plan, extract_diagonal_halo)

__all__ = ["make_row_mesh", "pad_matrix_rows", "shard_matrix",
           "shard_hierarchy", "replicate", "HaloELL", "build_halo",
           "RowMesh", "ShardedELL", "shard_vector", "build_halo_plan",
           "extract_diagonal_halo"]
