"""The Hopper keys kernel (rtgs_tpu_torch/ops/csrc/keys.cu) against its
plain torch twin, on the card. Imports no JAX, so it runs where only the
port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_keys_cuda.py

Both evaluate t1 with the same f32 operations in the same order and the
kernel is built without FMA contraction, so t1 and ids must be bitwise
equal; with chunk_lb (exact early exit) the kernel must be bitwise equal
to itself without it."""

import numpy as np
import pytest
import torch

from rtgs_tpu_torch.camera import camera_from_fov
from rtgs_tpu_torch.ops.peel import (CHUNK, MAX_DEPTH, _counts, peel_keys,
                                     peel_keys_cuda, peel_keys_torch)
from rtgs_tpu_torch.render.binning import tile_candidates
from rtgs_tpu_torch.render.tiled import (_tile_pixel_features, pack_features,
                                         precompute_features,
                                         render_tiled_keys)
from rtgs_tpu_torch.scene import random_scene
from rtgs_tpu_torch.viewer.orbit import orbit_camera_pose


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _frame(device, n=3000, res=(64, 48)):
    g = random_scene(n, extent=0.6, scale_range=(0.01, 0.06), seed=2,
                     device=device)
    pos, rot, _, _ = orbit_camera_pose(0.3, 1.2, 2.0, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    cam = camera_from_fov(pos, rot, res, 60.0, device=device)
    b = tile_candidates(g, cam, max_candidates=1024, max_global=64,
                        chunk=CHUNK)
    packed = pack_features(precompute_features(g, cam))
    return g, cam, b, packed, _tile_pixel_features(cam, (16, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 8, 12, 16, 40, 64])
def test_kernel_matches_twin(cuda, depth):
    _, _, b, packed, pix = _frame(cuda)
    cand = b.candidates
    assert int((cand >= 0).sum(1).max()) > 2 * CHUNK
    counts = _counts(cand)
    zeros = torch.zeros_like(b.chunk_lb)
    t1_k, sid_k = peel_keys_cuda(packed, cand, counts, zeros, pix, depth)
    t1_e, sid_e = peel_keys_cuda(packed, cand, counts, b.chunk_lb, pix,
                                 depth)
    t1_t, sid_t = peel_keys_torch(packed, cand, pix, depth)
    torch.cuda.synchronize()
    assert torch.equal(sid_k, sid_t) and torch.equal(t1_k, t1_t)
    assert torch.equal(sid_e, sid_k) and torch.equal(t1_e, t1_k)
    assert (sid_k >= 0).any()


@pytest.mark.cuda
def test_render_through_kernel_matches_twin(cuda):
    g, cam, _, _, _ = _frame(cuda)
    kw = dict(depth=16, max_candidates=1024, max_global=64, tile_bands=2)
    before = peel_keys_cuda.launches
    img_k = render_tiled_keys(g, cam, keys_impl="auto", **kw)
    assert peel_keys_cuda.launches == before + 2
    img_t = render_tiled_keys(g, cam, keys_impl="torch", **kw)
    assert torch.isfinite(img_k).all()
    assert torch.equal(img_k, img_t)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
    _, _, b, packed, pix = _frame(cuda, n=200, res=(32, 32))
    cand, lb = b.candidates, b.chunk_lb
    counts = _counts(cand)
    with pytest.raises(ValueError, match="depth"):
        peel_keys_cuda(packed, cand, counts, lb, pix, MAX_DEPTH + 1)
    with pytest.raises(ValueError, match="candidates is torch.int64"):
        peel_keys_cuda(packed, cand.long(), counts, lb, pix, 8)
    with pytest.raises(ValueError, match="not contiguous"):
        peel_keys_cuda(packed, cand, counts, lb, pix.transpose(1, 2)
                       .contiguous().transpose(1, 2), 8)
    with pytest.raises(ValueError, match="multiple of"):
        peel_keys(packed, cand[:, :100].contiguous(), pix, 8)


def test_kernel_refuses_cpu_tensors():
    """The wrapper never runs the twin for a caller: CPU tensors raise."""
    _, _, b, packed, pix = _frame("cpu", n=200, res=(32, 32))
    before = peel_keys_cuda.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        peel_keys_cuda(packed, b.candidates, _counts(b.candidates),
                       b.chunk_lb, pix, 8)
    assert peel_keys_cuda.launches == before
