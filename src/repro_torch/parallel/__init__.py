"""The parallel layer: logical sharding rules resolved on a device mesh."""
from repro_torch.parallel.sharding import (  # noqa: F401
    LOGICAL_RULES,
    AbstractMesh,
    Layout,
    P,
    active_mesh,
    axis_group,
    constrain,
    gather_shard,
    local_shard,
    make_mesh_from_config,
    placements,
    resolve,
    resolve_tree,
    use_mesh,
)
