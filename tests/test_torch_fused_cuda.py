"""The Hopper fused-peel kernels (rtgs_tpu_torch/ops/csrc/peel_fwd.cu and
peel_bwd.cu) against their plain torch twins, on the card. Imports no JAX,
so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_fused_cuda.py

Both select by the same float64 t1 chain and (t1, slot) order, so the
winners' slots must be bitwise equal. Shading is f32 in the same operation
order (built without FMA contraction); radiance and transmittance must
agree to 1e-5 absolute. The backward kernel returns the gradient of the
(N+1, 64) feature table in two stages: a slot's row summed over its tile's
pixels in a fixed order (stable counting sort), then each splat's pair rows
summed in order by segment_rows.cu; against the twin's per-slot gradients
(summed by the same segment sum, its products from torch's elementwise
kernels) each feature lane must agree to 1e-4 of that lane's largest entry,
and the sentinel row N must be exactly 0."""

import numpy as np
import pytest
import torch

from rtgs_tpu_torch.camera import camera_from_fov
from rtgs_tpu_torch.ops.peel import (CHUNK, MAX_DEPTH, _counts, _safe_ids,
                                     _scatter_slot_grads, entry_depth,
                                     peel_fused,
                                     peel_fused_bwd_cuda,
                                     peel_fused_bwd_torch, peel_fused_cuda,
                                     peel_fused_torch)
from rtgs_tpu_torch.render.binning import tile_candidates
from rtgs_tpu_torch.render.tiled import (_tile_pixel_features, pack_features,
                                         precompute_features,
                                         render_tiled_pallas)
from rtgs_tpu_torch.scene import random_scene
from rtgs_tpu_torch.viewer.orbit import orbit_camera_pose
from _torch_frames import SWEEP_SHAPES, sweep_inputs

FWD_ATOL = 1e-5
BWD_LANE_RTOL = 1e-4


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
    return g, cam, b.candidates, packed, _tile_pixel_features(cam, (16, 16))


def assert_tables_close(got, ref, rtol=BWD_LANE_RTOL):
    """(N+1, 64) table gradients: per lane, and the sentinel row exactly 0."""
    assert got.shape == ref.shape
    scale = ref.abs().amax(dim=0) + 1e-30               # per lane
    err = ((got - ref).abs().amax(dim=0) / scale).max()
    assert float(err) <= rtol, float(err)
    assert (got[-1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 16, 64])
def test_kernels_match_twins(cuda, depth):
    _, _, cand, packed, pix = _frame(cuda)
    assert int((cand >= 0).sum(1).max()) > 2 * CHUNK
    counts = _counts(cand)
    rad_k, tr_k, sl_k = peel_fused_cuda(packed, cand, counts, pix, depth)
    rad_t, tr_t, sl_t = peel_fused_torch(packed, cand, pix, depth)
    torch.cuda.synchronize()
    assert torch.equal(sl_k, sl_t) and (sl_k >= 0).any()
    assert (rad_k - rad_t).abs().max() <= FWD_ATOL
    assert (tr_k - tr_t).abs().max() <= FWD_ATOL
    gen = torch.Generator(device=cuda).manual_seed(depth)
    g_rad = torch.randn(rad_k.shape, generator=gen, device=cuda)
    g_tr = torch.randn(tr_k.shape, generator=gen, device=cuda)
    d_k = peel_fused_bwd_cuda(packed, cand, counts, pix, sl_k, g_rad, g_tr,
                              depth)
    d_t = _scatter_slot_grads(packed, cand, peel_fused_bwd_torch(
        packed, cand, pix, sl_t, g_rad, g_tr))
    torch.cuda.synchronize()
    assert torch.isfinite(d_k).all() and d_k.abs().max() > 0
    assert_tables_close(d_k, d_t)
    # The forward is deterministic, bitwise.
    rad_2, tr_2, sl_2 = peel_fused_cuda(packed, cand, counts, pix, depth)
    assert torch.equal(rad_2, rad_k) and torch.equal(tr_2, tr_k)
    assert torch.equal(sl_2, sl_k)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [8, 16, 32, 64])
@pytest.mark.parametrize("shape", sorted(SWEEP_SHAPES))
def test_screened_sweep_winners_bitwise(cuda, shape, depth):
    """Every list capacity the kernel is built for: the winners' slots are
    bitwise the twin's, radiance and transmittance to FWD_ATOL; the
    counting instantiation gives the same result, sweeps every (pixel, live
    candidate) pair and rejects no more than the misses."""
    packed, cand, pix = sweep_inputs(cuda, shape)
    if shape == "ragged_tile":
        assert pix.shape[1] % 32 != 0
    counts = _counts(cand)
    rad_k, tr_k, sl_k = peel_fused_cuda(packed, cand, counts, pix, depth)
    rad_t, tr_t, sl_t = peel_fused_torch(packed, cand, pix, depth)
    torch.cuda.synchronize()
    assert torch.equal(sl_k, sl_t) and (sl_k >= 0).any()
    assert (rad_k - rad_t).abs().max() <= FWD_ATOL
    assert (tr_k - tr_t).abs().max() <= FWD_ATOL
    counters = torch.zeros(2, dtype=torch.int64, device=cuda)
    rad_c, tr_c, sl_c = peel_fused_cuda(packed, cand, counts, pix, depth,
                                        screen_counts=counters)
    assert torch.equal(sl_c, sl_k) and torch.equal(rad_c, rad_k)
    assert torch.equal(tr_c, tr_k)
    pairs, rejected = (int(x) for x in counters)
    assert pairs == int((cand >= 0).sum()) * pix.shape[1]
    hits = int(torch.isfinite(entry_depth(
        packed[:, :10][_safe_ids(packed, cand)], pix)
        [(cand >= 0)[:, None, :].expand(-1, pix.shape[1], -1)]).sum())
    assert 0 < rejected <= pairs - hits


@pytest.mark.cuda
@pytest.mark.parametrize("res", [(24, 24), (64, 48)])
def test_backward_with_gaps_and_small_tiles(cuda, res):
    """Interior −1 gaps in the candidate lists, vacant layers, and tiles of
    fewer pixels than a warp group (8×8 tiles: blocks of 64 threads)."""
    g, cam, _, packed, _ = _frame(cuda, n=1500, res=res)
    pix = _tile_pixel_features(cam, (8, 8))
    b = tile_candidates(g, cam, tile=(8, 8), max_candidates=1024,
                        max_global=64, chunk=CHUNK)
    cand = b.candidates.clone()
    cand[:, 3::7] = -1
    counts = _counts(cand)
    rad, tr, sl = peel_fused_cuda(packed, cand, counts, pix, 16)
    assert torch.equal(sl, peel_fused_torch(packed, cand, pix, 16)[2])
    gen = torch.Generator(device=cuda).manual_seed(3)
    g_rad = torch.randn(rad.shape, generator=gen, device=cuda)
    g_tr = torch.randn(tr.shape, generator=gen, device=cuda)
    d_k = peel_fused_bwd_cuda(packed, cand, counts, pix, sl, g_rad, g_tr, 16)
    d_t = _scatter_slot_grads(packed, cand, peel_fused_bwd_torch(
        packed, cand, pix, sl, g_rad, g_tr))
    assert_tables_close(d_k, d_t)


@pytest.mark.cuda
def test_banded_render_through_kernels_matches_twins(cuda):
    g, cam, _, _, _ = _frame(cuda)
    kw = dict(depth=16, max_candidates=1024, max_global=64, tile_bands=2)

    def render_and_grad(impl):
        means = g.means.detach().clone().requires_grad_()
        colors = g.colors.detach().clone().requires_grad_()
        scene = type(g)(means=means, quats=g.quats, scales=g.scales,
                        colors=colors, opacities=g.opacities, sh=g.sh,
                        mask=g.mask)
        img = render_tiled_pallas(scene, cam, peel_impl=impl, **kw)
        (img ** 2).sum().backward()
        return img.detach(), means.grad, colors.grad

    fwd0, bwd0 = peel_fused_cuda.launches, peel_fused_bwd_cuda.launches
    img_k, gm_k, gc_k = render_and_grad("auto")
    assert peel_fused_cuda.launches == fwd0 + 2
    assert peel_fused_bwd_cuda.launches == bwd0 + 2
    img_t, gm_t, gc_t = render_and_grad("torch")
    assert torch.isfinite(img_k).all() and img_k.max() > 0.05
    assert (img_k - img_t).abs().max() <= FWD_ATOL
    for got, ref in ((gm_k, gm_t), (gc_k, gc_t)):
        assert torch.isfinite(got).all()
        err = (got - ref).abs().max() / ref.abs().max()
        assert float(err) <= 1e-4, float(err)


@pytest.mark.cuda
def test_kernels_reject_bad_inputs(cuda):
    _, _, cand, packed, pix = _frame(cuda, n=200, res=(32, 32))
    counts = _counts(cand)
    with pytest.raises(ValueError, match="depth"):
        peel_fused_cuda(packed, cand, counts, pix, MAX_DEPTH + 1)
    with pytest.raises(ValueError, match="candidates is torch.int64"):
        peel_fused_cuda(packed, cand.long(), counts, pix, 8)
    with pytest.raises(ValueError, match="multiple of"):
        peel_fused(packed, cand[:, :100].contiguous(), pix, 8)
    rad, tr, sl = peel_fused_cuda(packed, cand, counts, pix, 8)
    with pytest.raises(ValueError, match="slots has shape"):
        peel_fused_bwd_cuda(packed, cand, counts, pix, sl[:, :4].contiguous(),
                            rad, tr, 8)
    with pytest.raises(ValueError, match="not contiguous"):
        peel_fused_bwd_cuda(packed, cand, counts, pix, sl,
                            rad.transpose(1, 2).contiguous().transpose(1, 2),
                            tr, 8)


def test_kernels_refuse_cpu_tensors():
    """The wrappers never run the twins for a caller: CPU tensors raise."""
    _, _, cand, packed, pix = _frame("cpu", n=200, res=(32, 32))
    counts = _counts(cand)
    before = peel_fused_cuda.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        peel_fused_cuda(packed, cand, counts, pix, 8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        peel_fused(packed, cand, pix, 8, impl="cuda")
    assert peel_fused_cuda.launches == before
