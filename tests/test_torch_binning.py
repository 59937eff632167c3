"""Port binning (rtgs_tpu_torch.render.binning.tile_candidates) against the
JAX package's tile_candidates(..., chunk=128) on the same scene and camera.

Counts and overflow counters must be equal exactly. Each tile's candidate
SET must be equal: jax.lax.sort is unstable and the port's torch.sort is
stable, so the order among equal keys may differ. chunk_lb must agree
within one quantisation step of the depth bound, dmax / 65535."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtgs_tpu import gaussians as JG
from rtgs_tpu.camera import camera_from_fov
from rtgs_tpu.ops.peel import CHUNK as J_CHUNK
from rtgs_tpu.render.binning import tile_candidates as j_tile_candidates
from rtgs_tpu.viewer.orbit import orbit_camera_pose
from rtgs_tpu_torch.bridge import camera_from_numpy, gaussians_from_numpy
from rtgs_tpu_torch.ops.peel import CHUNK
from rtgs_tpu_torch.render.binning import tile_candidates
from rtgs_tpu_torch.scene import random_scene_arrays

CASES = {
    # Fits: no tile reaches its budget, no global-list overflow.
    "fits": dict(n=500, extent=1.0, scale_range=(0.02, 0.1), r=3.0,
                 res=(64, 48), kw=dict(max_candidates=512, max_global=64)),
    # Overflows: tight local and global budgets, wide splats with a narrow
    # fan-out of 2 (wide class and global spill both in play).
    "overflows": dict(n=600, extent=0.6, scale_range=(0.02, 0.3), r=2.0,
                      res=(64, 48), kw=dict(max_candidates=48, max_global=8,
                                            narrow=2)),
}


def _inputs(case):
    c = CASES[case]
    fields = random_scene_arrays(c["n"], c["extent"], c["scale_range"],
                                 seed=7)
    jg = JG.Gaussians(**{k: jnp.asarray(v) for k, v in fields.items()})
    pos, rot, _, _ = orbit_camera_pose(0.3, 1.2, c["r"], np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    jcam = camera_from_fov(pos, rot, c["res"], 60.0)
    return (jg, jcam, gaussians_from_numpy(fields, device="cpu"),
            camera_from_numpy(jcam, device="cpu"), c["kw"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_binning_matches_jax(case):
    assert CHUNK == J_CHUNK
    jg, jcam, tg, tcam, kw = _inputs(case)
    jb = j_tile_candidates(jg, jcam, chunk=J_CHUNK, **kw)
    tb = tile_candidates(tg, tcam, chunk=CHUNK, **kw)

    assert (tb.n_tiles_x, tb.n_tiles_y) == (jb.n_tiles_x, jb.n_tiles_y)
    assert int(tb.local_overflow) == int(jb.local_overflow)
    assert int(tb.global_overflow) == int(jb.global_overflow)
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))
    if case == "overflows":
        assert int(jb.local_overflow) > 0 and int(jb.global_overflow) > 0

    jc, tc = np.asarray(jb.candidates), tb.candidates.numpy()
    assert tc.shape == jc.shape and tc.dtype == np.int32
    for t in range(jc.shape[0]):
        # Valid ids form a prefix of each row in both.
        n_t = int(jb.counts[t])
        assert (tc[t, n_t:] == -1).all() and (tc[t, :n_t] >= 0).all()
        assert sorted(tc[t, :n_t]) == sorted(jc[t, :n_t]), f"tile {t}"

    # One quantisation step of the depth bound.
    jlb, tlb = np.asarray(jb.chunk_lb), tb.chunk_lb.numpy()
    assert tlb.shape == jlb.shape
    assert (np.isinf(tlb) == np.isinf(jlb)).all()
    fin = np.isfinite(jlb)
    step = float(np.max(jlb[fin])) / 65535.0 + 1e-12
    assert np.abs(tlb[fin] - jlb[fin]).max() <= step


def test_chunk_lb_is_a_sound_bound():
    """Every candidate in chunk c or later enters at t1 >= chunk_lb[c]."""
    from rtgs_tpu_torch.ops.peel import entry_depth
    from rtgs_tpu_torch.render.tiled import (_tile_pixel_features,
                                             pack_features,
                                             precompute_features)

    fields = random_scene_arrays(3000, 0.6, (0.01, 0.06), seed=3)
    g = gaussians_from_numpy(fields, device="cpu")
    pos, rot, _, _ = orbit_camera_pose(0.3, 1.2, 2.0, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    cam = camera_from_numpy(camera_from_fov(pos, rot, (32, 32), 60.0),
                            device="cpu")
    b = tile_candidates(g, cam, max_candidates=1024, max_global=64,
                        chunk=CHUNK)
    cand = b.candidates
    assert int((cand >= 0).sum(1).max()) > CHUNK  # multi-chunk tiles
    packed = pack_features(precompute_features(g, cam))
    pix = _tile_pixel_features(cam, (16, 16))
    rows = packed[torch.where(cand >= 0, cand, packed.shape[0] - 1)]
    t1 = entry_depth(rows, pix).amin(1).numpy()          # (T, C)
    lb = b.chunk_lb.numpy()
    for c in range(cand.shape[1] // CHUNK):
        assert not (t1[:, c * CHUNK:] < lb[:, c:c + 1] - 1e-5).any(), c
