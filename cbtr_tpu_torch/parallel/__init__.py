"""Multi-rank parallelism on torch.distributed: device meshes, ray and patch
sharding, sharded train steps (the counterpart of cbtr_tpu/parallel).
Importing it starts no process group."""
from .sharding import (  # noqa: F401
    make_sharded_train_step,
    ray_device_mesh,
    render_sharded,
    replicate,
    shard_rays,
)
from .patch_parallel import intersect_rays_patch_sharded, pad_patches  # noqa: F401
