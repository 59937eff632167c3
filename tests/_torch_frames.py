"""Inputs shared by the port's ``cuda``-marked kernel tests (no JAX).
Imported by its bare name: pytest puts this directory on ``sys.path``."""

import numpy as np

from rtgs_tpu_torch.camera import camera_from_fov
from rtgs_tpu_torch.ops.peel import CHUNK
from rtgs_tpu_torch.render.binning import tile_candidates
from rtgs_tpu_torch.render.tiled import (_tile_pixel_features, pack_features,
                                         precompute_features)
from rtgs_tpu_torch.scene import random_scene
from rtgs_tpu_torch.viewer.orbit import orbit_camera_pose

# Shapes that strain the screened, batched sweep: one candidate chunk, 29
# of them, and tiles of 100 pixels (a block of three warps and a ragged
# fourth): (splats, resolution, tile, max_candidates, max_global).
SWEEP_SHAPES = {
    "one_chunk": (400, (32, 32), (16, 16), 64, 64),
    "29_chunks": (30_000, (32, 32), (16, 16), 29 * CHUNK - 128, 128),
    "ragged_tile": (3000, (40, 30), (10, 10), 1024, 64),
}


def sweep_inputs(device, shape):
    """(packed, candidates, pix) of one of ``SWEEP_SHAPES``."""
    n, res, tile, cmax, gmax = SWEEP_SHAPES[shape]
    g = random_scene(n, extent=0.6, scale_range=(0.01, 0.06), seed=2,
                     device=device)
    pos, rot, _, _ = orbit_camera_pose(0.3, 1.2, 2.0, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    cam = camera_from_fov(pos, rot, res, 60.0, device=device)
    b = tile_candidates(g, cam, tile=tile, max_candidates=cmax,
                        max_global=gmax, chunk=CHUNK)
    want_c = CHUNK if shape == "one_chunk" else (
        29 * CHUNK if shape == "29_chunks" else b.candidates.shape[1])
    assert b.candidates.shape[1] == want_c
    packed = pack_features(precompute_features(g, cam))
    return packed, b.candidates, _tile_pixel_features(cam, tile)
