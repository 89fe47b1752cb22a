"""Device meshes over ``torch.distributed``: the ('data', 'particle') rank
grid, its process groups and the collectives the filter needs."""

from nfdpf_torch.parallel.mesh import (
    constrain,
    make_mesh,
    replicate,
    shard_batch,
)

__all__ = ["make_mesh", "shard_batch", "replicate", "constrain"]
