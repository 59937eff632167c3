from rtgs_tpu_torch.parallel.mesh import PRIMS_AXIS, RAYS_AXIS, make_mesh
from rtgs_tpu_torch.parallel.render import render_sharded, shard_scene

__all__ = [
    "RAYS_AXIS",
    "PRIMS_AXIS",
    "make_mesh",
    "render_sharded",
    "shard_scene",
]
