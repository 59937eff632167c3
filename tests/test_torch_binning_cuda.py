"""The binning kernels (rtgs_tpu_torch/ops/csrc/binning.cu) against the
plain chain, on the card. Imports no JAX, so it runs where only the port is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_binning_cuda.py

Both compute every splat's box with the same f32 operations in the same
order (the kernels built without FMA contraction) and sort the live pairs
stably in the plain chain's slot order, so every field of the
``TileBinning`` must be bitwise equal: at the benchmark's two
configurations (the 1M scene at 1920x1088 with budgets 4608 / 128 / narrow
4 at 8 orbit poses, with and without ``chunk`` and ``entry_lb``; the 100k
scene at 512x384, budgets 1536 / 128, at its 12 views), and on splats behind
the camera, a wide class past its budget, tiles past a small budget (the
farthest-first drop order) and more than 32,767 tiles (keys of the tile
alone). Every frame of the main path launches the kernels once."""

import math

import numpy as np
import pytest
import torch

from rtgs_tpu_torch.camera import camera_from_fov
from rtgs_tpu_torch.ops.peel import CHUNK
from rtgs_tpu_torch.render import binning as B
from rtgs_tpu_torch.render.tiled import (entry_lower_bound, pack_features,
                                         precompute_features)
from rtgs_tpu_torch.scene import random_scene
from rtgs_tpu_torch.viewer.orbit import orbit_camera_pose

FIELDS = ("candidates", "counts", "local_overflow", "global_overflow",
          "chunk_lb")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _camera(theta, res, device, phi=1.2, r=5.0):
    pos, rot, _, _ = orbit_camera_pose(theta, phi, r, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    return camera_from_fov(pos, rot, res, 60.0, device=device)


def _same(g, cam, **kw):
    """The kernels' binning, after asserting it bitwise the plain chain's
    on the same CUDA tensors (one kernel call)."""
    before = B.tile_candidates_cuda.launches
    k = B.tile_candidates(g, cam, **kw)
    assert B.tile_candidates_cuda.launches == before + 1
    p = B.tile_candidates_torch(g, cam, **kw)
    torch.cuda.synchronize()
    assert (k.n_tiles_x, k.n_tiles_y) == (p.n_tiles_x, p.n_tiles_y)
    for f in FIELDS:
        x, y = getattr(k, f), getattr(p, f)
        if y is None:
            assert x is None, f
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert torch.equal(x, y), (f, int((x != y).sum()))
    return k


@pytest.fixture(scope="module")
def scene1m():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return random_scene(1_000_000, extent=2.0, scale_range=(0.005, 0.03),
                        seed=11, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pose", range(8))
def test_d16_configuration(cuda, scene1m, pose):
    g = scene1m
    cam = _camera(0.3 + 2 * math.pi * pose / 8, (1920, 1088), cuda)
    kw = dict(tile=(16, 16), max_candidates=4608, max_global=128, narrow=4)
    b = _same(g, cam, **kw)
    assert int(b.counts.sum()) > 4_000_000
    _same(g, cam, chunk=CHUNK, **kw)
    lb = entry_lower_bound(g, cam, pack_features(precompute_features(g, cam)))
    b = _same(g, cam, chunk=CHUNK, entry_lb=lb, **kw)
    assert torch.isfinite(b.chunk_lb).any()


@pytest.mark.cuda
def test_fit_configuration(cuda):
    g = random_scene(100_000, extent=2.0, scale_range=(0.005, 0.03), seed=5,
                     device=cuda)
    for v in range(12):
        cam = _camera(2 * math.pi * v / 12, (512, 384), cuda)
        _same(g, cam, max_candidates=1536, max_global=128)


@pytest.mark.cuda
def test_behind_the_camera(cuda):
    """A camera inside the scene: splats behind it or across its plane go
    to the global list, which overflows its budget."""
    g = random_scene(50_000, extent=2.0, scale_range=(0.005, 0.03), seed=3,
                     device=cuda)
    cam = _camera(0.7, (640, 384), cuda, r=0.5)
    b = _same(g, cam, max_candidates=1024, max_global=64, chunk=CHUNK)
    assert int(b.global_overflow) > 0


@pytest.mark.cuda
def test_wide_class_spills(cuda):
    """More wide splats than the budget max(64, N/16): the rest spill to
    the global list."""
    g = random_scene(4_000, extent=1.0, scale_range=(0.05, 0.15), seed=4,
                     device=cuda)
    cam = _camera(0.2, (1280, 720), cuda, r=3.0)
    kw = dict(max_candidates=2048, max_global=4096, narrow=2, chunk=CHUNK)
    lay = B._layout(g.num, cam, (16, 16), 2048, None, 4096, 2, CHUNK)
    live, behind, _, _, wx, wy, _ = B._splat_boxes(g, cam, 0.0, lay)
    local = live & ~(behind | (wx > lay.mtx) | (wy > lay.mty))
    wide = local & ((wx > lay.narrow) | (wy > lay.narrow))
    assert lay.wide_slots and int(wide.sum()) > lay.wlimit
    _same(g, cam, **kw)


@pytest.mark.cuda
def test_small_budget_drops_farthest_first(cuda):
    g = random_scene(100_000, extent=2.0, scale_range=(0.005, 0.03), seed=6,
                     device=cuda)
    cam = _camera(1.1, (640, 384), cuda)
    b = _same(g, cam, max_candidates=96, max_global=128, chunk=CHUNK)
    assert int(b.local_overflow) > 0
    assert int((b.counts == 96).sum()) > 0


@pytest.mark.cuda
def test_tile_only_keys(cuda):
    """More than 32,767 tiles: keys of the tile alone, chunk_lb 0."""
    g = random_scene(20_000, extent=2.0, scale_range=(0.005, 0.03), seed=8,
                     device=cuda)
    cam = _camera(0.4, (1024, 512), cuda)
    b = _same(g, cam, tile=(4, 4), max_candidates=256, max_global=64,
              chunk=CHUNK)
    assert b.n_tiles_x * b.n_tiles_y > 32767
    assert int(b.counts.max()) > 1 and not b.chunk_lb.any()


@pytest.mark.cuda
def test_main_path_launches_the_kernels(cuda):
    """render(auto) and render(keys) bin through the kernels, once a
    frame."""
    from rtgs_tpu_torch.render.api import render

    g = random_scene(20_000, extent=2.0, scale_range=(0.005, 0.03), seed=9,
                     device=cuda)
    cam = _camera(0.4, (320, 192), cuda)
    for renderer in ("auto", "keys"):
        before = B.tile_candidates_cuda.launches
        with torch.no_grad():
            render(g, cam, renderer=renderer, max_candidates=1024)
        torch.cuda.synchronize()
        assert B.tile_candidates_cuda.launches == before + 1, renderer
