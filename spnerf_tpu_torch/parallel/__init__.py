from spnerf_tpu_torch.parallel.mesh import (
    make_mesh,
    shard_batch,
    replicate,
)

__all__ = ["make_mesh", "shard_batch", "replicate"]
