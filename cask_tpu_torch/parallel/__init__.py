"""Multi-device distribution over ``torch.distributed``: partitioning, halo
exchange, the shard executors and a launcher for a world of ranks."""

from cask_tpu_torch.parallel.dist import (  # noqa: F401
    Dist2DSpmv,
    DistSpmv,
    ShardOperator,
    resolve_interiors,
    slab_choice,
)
from cask_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh2D,
    RowMesh,
    init_world,
    launch,
    mesh_2d,
    row_mesh,
)
from cask_tpu_torch.parallel.partition import (  # noqa: F401
    BdiaPartition,
    Coo2DPartition,
    CooPartition,
    DiaPartition,
    PohPartition,
    fem_bdia_partition,
    fem_formula_bsr,
    partition_2d,
    partition_bdia,
    partition_coo,
    partition_dia,
    partition_poh,
    stencil_dia_partition,
)
