"""The Hopper top-K peel kernels (rtgs_tpu_torch/ops/csrc/peel_topk_fwd.cu
and peel_topk_bwd.cu) against their plain torch twins, on the card.
Imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_topk_cuda.py

Kernel and twin select by the same float64 t1 chain and (t1, slot) order,
so the winners' slots and t1 must be bitwise equal. α and rgb are f32 in
the same operation order (built without FMA contraction) and must agree to
1e-5 absolute. The backward kernel returns the gradient of the (N+1, 64)
table (the fused backward's two stages, sums in fixed orders): against the
twin's per-slot gradients each feature lane must agree to 1e-4 of that
lane's largest entry, and the sentinel row must be exactly 0. The K-list
composited by composite_hits equals the fused peel's radiance and
transmittance to 1e-5 (the same layers, summed in another order)."""

import numpy as np
import pytest
import torch

from rtgs_tpu_torch.camera import camera_from_fov
from rtgs_tpu_torch.ops.peel import (CHUNK, MAX_DEPTH, _counts,
                                     _scatter_slot_grads, peel_fused,
                                     peel_fused_cuda, peel_topk,
                                     peel_topk_bwd_cuda, peel_topk_bwd_torch,
                                     peel_topk_cuda, peel_topk_torch)
from rtgs_tpu_torch.render.binning import tile_candidates
from rtgs_tpu_torch.render.oracle import composite_hits
from rtgs_tpu_torch.render.tiled import (_tile_pixel_features, pack_features,
                                         precompute_features)
from rtgs_tpu_torch.scene import random_scene
from rtgs_tpu_torch.viewer.orbit import orbit_camera_pose
from _torch_frames import SWEEP_SHAPES, sweep_inputs

LAYER_ATOL = 1e-5
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
    return b.candidates, packed, _tile_pixel_features(cam, (16, 16))


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
    cand, packed, pix = _frame(cuda)
    assert int((cand >= 0).sum(1).max()) > 2 * CHUNK
    counts = _counts(cand)
    lay_k, sl_k = peel_topk_cuda(packed, cand, counts, pix, depth)
    lay_t, sl_t = peel_topk_torch(packed, cand, pix, depth)
    torch.cuda.synchronize()
    assert torch.equal(sl_k, sl_t) and (sl_k >= 0).any()
    assert torch.equal(lay_k[:, 0], lay_t[:, 0])                  # t1
    assert (lay_k[:, 1:] - lay_t[:, 1:]).abs().max() <= LAYER_ATOL
    vacant = sl_k < 0
    assert torch.isinf(lay_k[:, 0][vacant]).all()
    assert (lay_k[:, 1:].transpose(0, 1)[:, vacant] == 0).all()
    # The fused forward kernel picks the same winners.
    assert torch.equal(peel_fused_cuda(packed, cand, counts, pix, depth)[2],
                       sl_k)
    gen = torch.Generator(device=cuda).manual_seed(depth)
    g_lay = torch.randn((cand.shape[0], 4, depth, pix.shape[1]),
                        generator=gen, device=cuda)
    d_k = peel_topk_bwd_cuda(packed, cand, counts, pix, sl_k, g_lay, depth)
    d_t = _scatter_slot_grads(packed, cand, peel_topk_bwd_torch(
        packed, cand, pix, sl_t, g_lay))
    torch.cuda.synchronize()
    assert torch.isfinite(d_k).all() and d_k.abs().max() > 0
    assert_tables_close(d_k, d_t)
    # The forward is deterministic, bitwise.
    lay_2, sl_2 = peel_topk_cuda(packed, cand, counts, pix, depth)
    assert torch.equal(lay_2, lay_k) and torch.equal(sl_2, sl_k)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [8, 16, 32, 64])
@pytest.mark.parametrize("shape", sorted(SWEEP_SHAPES))
def test_screened_sweep_winners_bitwise(cuda, shape, depth):
    """The top-K forward runs the fused forward's sweep: slots and t1
    bitwise the twin's at every list capacity, with one candidate chunk,
    with 29, and with tiles that are no multiple of a warp."""
    packed, cand, pix = sweep_inputs(cuda, shape)
    lay_k, sl_k = peel_topk_cuda(packed, cand, _counts(cand), pix, depth)
    lay_t, sl_t = peel_topk_torch(packed, cand, pix, depth)
    torch.cuda.synchronize()
    assert torch.equal(sl_k, sl_t) and (sl_k >= 0).any()
    assert torch.equal(lay_k[:, 0], lay_t[:, 0])
    assert (lay_k[:, 1:] - lay_t[:, 1:]).abs().max() <= LAYER_ATOL


@pytest.mark.cuda
def test_klist_composite_matches_fused(cuda):
    """composite_hits of the K-list through the top-K kernels equals the
    fused peel through its kernels, forward and scene-feature gradient."""
    cand, packed, pix = _frame(cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    w = torch.randn((cand.shape[0], 3, pix.shape[1]), generator=gen,
                    device=cuda)

    def via_topk(pk):
        t1, a, r, g, b = peel_topk(pk, cand, pix, 16)
        return composite_hits(t1, a, torch.stack([r, g, b], dim=-1))

    def via_fused(pk):
        rad, trans = peel_fused(pk, cand, pix, 16)
        return rad.transpose(1, 2), trans

    grads = []
    before = peel_topk_cuda.launches, peel_topk_bwd_cuda.launches
    for fn in (via_topk, via_fused):
        pk = packed.clone().requires_grad_()
        rad, trans = fn(pk)
        ((rad * w.transpose(1, 2)).sum() + trans.sum()).backward()
        grads.append((rad.detach(), trans.detach(), pk.grad))
    assert (peel_topk_cuda.launches, peel_topk_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    (rad_k, tr_k, g_k), (rad_f, tr_f, g_f) = grads
    assert (rad_k - rad_f).abs().max() <= LAYER_ATOL
    assert (tr_k - tr_f).abs().max() <= LAYER_ATOL
    assert torch.isfinite(g_k).all()
    err = (g_k - g_f).abs().max() / g_f.abs().max()
    assert float(err) <= 1e-4, float(err)


@pytest.mark.cuda
def test_kernels_reject_bad_inputs(cuda):
    cand, packed, pix = _frame(cuda, n=200, res=(32, 32))
    counts = _counts(cand)
    with pytest.raises(ValueError, match="depth"):
        peel_topk_cuda(packed, cand, counts, pix, MAX_DEPTH + 1)
    with pytest.raises(ValueError, match="candidates is torch.int64"):
        peel_topk_cuda(packed, cand.long(), counts, pix, 8)
    with pytest.raises(ValueError, match="multiple of"):
        peel_topk(packed, cand[:, :100].contiguous(), pix, 8)
    _, sl = peel_topk_cuda(packed, cand, counts, pix, 8)
    g_lay = torch.zeros((cand.shape[0], 4, 8, pix.shape[1]), device=cuda)
    with pytest.raises(ValueError, match="slots has shape"):
        peel_topk_bwd_cuda(packed, cand, counts, pix, sl[:, :4].contiguous(),
                           g_lay, 8)
    with pytest.raises(ValueError, match="grad_layers has shape"):
        peel_topk_bwd_cuda(packed, cand, counts, pix, sl, g_lay[:, :3], 8)
    with pytest.raises(ValueError, match="not contiguous"):
        peel_topk_bwd_cuda(packed, cand, counts, pix, sl,
                           g_lay.transpose(2, 3).contiguous().transpose(2, 3),
                           8)


def test_kernels_refuse_cpu_tensors():
    """The wrappers never run the twins for a caller: CPU tensors raise."""
    cand, packed, pix = _frame("cpu", n=200, res=(32, 32))
    counts = _counts(cand)
    before = peel_topk_cuda.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        peel_topk_cuda(packed, cand, counts, pix, 8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        peel_topk(packed, cand, pix, 8, impl="cuda")
    _, sl = peel_topk_torch(packed, cand, pix, 8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        peel_topk_bwd_cuda(packed, cand, counts, pix, sl,
                           torch.zeros((cand.shape[0], 4, 8, pix.shape[1])),
                           8)
    assert peel_topk_cuda.launches == before
