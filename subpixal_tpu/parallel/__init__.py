"""Multi-device sharding for the alignment pipeline.

The reference is a serial numpy program (SURVEY.md §2b: no parallelism of
any kind); these are new, first-class components: the cutout batch is
data-parallel over a ``jax.sharding.Mesh``, global sigma-clipped fits run
via ``lax.psum`` collectives inside ``shard_map``, and the joint multi-exposure alignment step (BASELINE
config 5) is one jit-compiled SPMD program.
"""

from .distributed import (
    global_batch_from_local,
    init_distributed,
    make_global_mesh,
    process_info,
    stage_global,
)
from .sharding import (
    make_mesh,
    make_sharded_align_step,
    pad_to_multiple,
    sharded_find_displacement,
    sharded_measure_and_fit,
)
from .spatial import (
    band_rows,
    drizzle_deposit_spatial,
    drizzle_deposit_sparse_spatial,
    drizzle_deposit_stack_spatial,
    gather_rows,
    halo_exchange,
    make_mesh2d,
    sample_spatial,
    shard_rows,
)

__all__ = [
    "make_mesh",
    "make_sharded_align_step",
    "pad_to_multiple",
    "sharded_find_displacement",
    "sharded_measure_and_fit",
    "band_rows",
    "shard_rows",
    "gather_rows",
    "halo_exchange",
    "make_mesh2d",
    "drizzle_deposit_spatial",
    "drizzle_deposit_sparse_spatial",
    "drizzle_deposit_stack_spatial",
    "sample_spatial",
    "init_distributed",
    "make_global_mesh",
    "global_batch_from_local",
    "process_info",
    "stage_global",
]
