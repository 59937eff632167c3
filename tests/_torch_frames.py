"""Inputs shared by the port's ``cuda``-marked kernel tests (no JAX).
Imported by its bare name: pytest puts this directory on ``sys.path``."""

import numpy as np

from rtgs_tpu_torch.camera import camera_from_fov
from rtgs_tpu_torch.ops.peel import CHUNK
from rtgs_tpu_torch.render.binning import tile_candidates
from rtgs_tpu_torch.render.tiled import (_tile_pixel_features,
                                         entry_lower_bound, pack_features,
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


# Peels deeper than one list (passes of MAX_DEPTH above a floor): a fog of
# large splats under a 20° field of view, so that a sixth of the pixels have
# 256 hits or more (64x48 in 16x16 tiles); tiles of 64x64 = 4096 pixels;
# and tiles of 20x20 = 400 pixels (a pixel group of 256, then a ragged 144).
DEEP_DEPTHS = (65, 96, 128, 256)
DEEP_SHAPES = {
    "16x16": ((64, 48), (16, 16), 2048, 64),
    "64x64": ((128, 64), (64, 64), 2048, 2048),
    "20x20": ((80, 60), (20, 20), 2048, 64),
}


def deep_inputs(device, shape="16x16"):
    """(packed, candidates, chunk_lb, pix) of one of ``DEEP_SHAPES``: 2000
    splats of scale 0.05-0.15 in a cube of half-size 0.3."""
    res, tile, cmax, gmax = DEEP_SHAPES[shape]
    g = random_scene(2000, extent=0.3, scale_range=(0.05, 0.15), seed=11,
                     device=device)
    pos, rot, _, _ = orbit_camera_pose(0.3, 1.2, 3.0, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    cam = camera_from_fov(pos, rot, res, 20.0, device=device)
    packed = pack_features(precompute_features(g, cam))
    b = tile_candidates(g, cam, tile=tile, max_candidates=cmax,
                        max_global=gmax, chunk=CHUNK,
                        entry_lb=entry_lower_bound(g, cam, packed))
    return packed, b.candidates, b.chunk_lb, _tile_pixel_features(cam, tile)
