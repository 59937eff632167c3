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
and the sentinel row N must be exactly 0. Deeper than MAX_DEPTH, peel_fused
chains the kernels in passes above each pixel's floor: the passes' slots
bitwise one twin call's at the whole depth, the chained composite and its
gradient at the same tolerances; tiles of 4096 pixels are swept and
contracted group after group. The deep pass (K = 64, a lane pair a pixel)
is held bitwise against the twin in every output, radiance and
transmittance included: the kernel shades and composites with the twin's
operations in its order."""

import numpy as np
import pytest
import torch

from rtgs_tpu_torch.camera import camera_from_fov
from rtgs_tpu_torch.ops.peel import (CHUNK, MAX_DEPTH, _counts,
                                     _fused_twin, _safe_ids,
                                     _scatter_slot_grads, _select,
                                     entry_depth, pass_depths, peel_fused,
                                     peel_fused_bwd_cuda,
                                     peel_fused_bwd_torch, peel_fused_cuda,
                                     peel_fused_torch)
from rtgs_tpu_torch.render.binning import tile_candidates
from rtgs_tpu_torch.render.tiled import (_tile_pixel_features, pack_features,
                                         precompute_features,
                                         render_tiled_pallas)
from rtgs_tpu_torch.scene import random_scene
from rtgs_tpu_torch.viewer.orbit import orbit_camera_pose
from _torch_frames import (DEEP_DEPTHS, SWEEP_SHAPES, deep_inputs,
                           sweep_inputs)

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


def _chained_slots(packed, cand, pix, depth):
    """The fused forward kernel in passes, each above the last winner of
    the one before; their slots concatenated along K."""
    counts, slots, floor = _counts(cand), [], None
    t, p = cand.shape[0], pix.shape[1]
    for k in pass_depths(depth):
        last = torch.empty((t, p), device=pix.device)
        _, _, sl = peel_fused_cuda(packed, cand, counts, pix, k, floor=floor,
                                   out_last_t1=last)
        slots.append(sl)
        floor = (last, sl[:, -1].contiguous())
    return torch.cat(slots, dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,depth", [("16x16", d) for d in DEEP_DEPTHS]
                         + [("64x64", 96)])
def test_chained_kernels_match_twin(cuda, shape, depth):
    """peel_fused at a depth of several passes: one launch of each kernel a
    pass; winners bitwise one twin call's; radiance, transmittance and the
    table gradient (the passes' backwards on the cotangents autograd
    chains) against the twin's one call."""
    packed, cand, _, pix = deep_inputs(cuda, shape)
    rad_t, tr_t, sl_t = peel_fused_torch(packed, cand, pix, depth)
    assert (sl_t[:, depth - 1] >= 0).any() or shape == "64x64"
    assert torch.equal(_chained_slots(packed, cand, pix, depth), sl_t)
    gen = torch.Generator(device=cuda).manual_seed(depth)
    g_rad = torch.randn(rad_t.shape, generator=gen, device=cuda)
    g_tr = torch.randn(tr_t.shape, generator=gen, device=cuda)
    x = packed.detach().clone().requires_grad_()
    fwd0, bwd0 = peel_fused_cuda.launches, peel_fused_bwd_cuda.launches
    rad_k, tr_k = peel_fused(x, cand, pix, depth)
    ((rad_k * g_rad).sum() + (tr_k * g_tr).sum()).backward()
    torch.cuda.synchronize()
    n_pass = len(pass_depths(depth))
    assert peel_fused_cuda.launches == fwd0 + n_pass
    assert peel_fused_bwd_cuda.launches == bwd0 + n_pass
    assert (rad_k - rad_t).abs().max() <= FWD_ATOL
    assert (tr_k - tr_t).abs().max() <= FWD_ATOL
    d_t = _scatter_slot_grads(packed, cand, peel_fused_bwd_torch(
        packed, cand, pix, sl_t, g_rad, g_tr))
    assert_tables_close(x.grad, d_t)


def _tied(packed, cand, third=500):
    """Every splat's row twice and the first ``third`` rows a third time,
    each copy a candidate of the tiles that list the splat: a hit ties bit
    for bit in t1 with its copies, at distinct slots."""
    n = packed.shape[0] - 1
    table = torch.cat([packed[:n], packed[:n], packed[:third], packed[n:]])
    live = cand >= 0
    return table, torch.cat([cand, torch.where(live, cand + n, -1),
                             torch.where(live & (cand < third), cand + 2 * n,
                                         -1)], dim=1).contiguous()


def _deep_case(device, case):
    """(packed, candidates, pix) of a K = 64 case (see its test)."""
    if case == "vacant":
        return sweep_inputs(device, "one_chunk")
    packed, cand, _, pix = deep_inputs(
        device, "20x20" if case == "ragged_group" else "16x16")
    if case == "ties":
        packed, cand = _tied(packed, cand)
    return packed, cand, pix


def _pass_bitwise(packed, cand, pix, depth, floor=None):
    """One pass through peel_fused_cuda (plain and counting) and through
    the twin above the same floor: slots, radiance, transmittance and the
    last layer's t1 bitwise. Returns the twin's (slots, last t1)."""
    t, p = cand.shape[0], pix.shape[1]
    last = torch.empty((t, p), device=pix.device)
    counters = torch.zeros(2, dtype=torch.int64, device=pix.device)
    got = peel_fused_cuda(packed, cand, _counts(cand), pix, depth,
                          floor=floor, out_last_t1=last)
    counted = peel_fused_cuda(packed, cand, _counts(cand), pix, depth,
                              screen_counts=counters, floor=floor)
    rad, tr, sl, last_t = _fused_twin(packed, cand, pix, depth, floor)
    torch.cuda.synchronize()
    for a, b, what in ((got[2], sl, "slots"), (got[0], rad, "radiance"),
                       (got[1], tr, "transmittance"), (last, last_t, "t1")):
        assert torch.equal(a, b), what
    assert all(torch.equal(a, b) for a, b in zip(counted, got))
    assert int(counters[0]) == int((cand >= 0).sum()) * p
    return sl, last_t


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["unstaged", "ragged_group", "vacant",
                                  "ties"])
def test_deep_pass_bitwise_twin(cuda, case):
    """The deep pass (K = 64, a lane pair a pixel) bitwise the twin: tiles
    past the 416 slots that shading stages (rows read from the table); 400
    pixels a tile (a group of 256 pixels, then a ragged one of 144); pixels
    with fewer than 64 hits (vacant layers); and hits whose t1 ties bit for
    bit, in the front half, the back half and across the two."""
    packed, cand, pix = _deep_case(cuda, case)
    sl, _ = _pass_bitwise(packed, cand, pix, MAX_DEPTH)
    assert (sl >= 0).any()
    if case == "unstaged":
        assert int(_counts(cand).max()) > 416
    elif case == "ragged_group":
        assert pix.shape[1] == 400
    elif case == "vacant":
        assert (sl[:, MAX_DEPTH - 1] < 0).any()
    else:
        t1 = _select(packed, cand, pix, MAX_DEPTH)[0]
        half = MAX_DEPTH // 2
        tie = torch.isfinite(t1[:, 1:]) & (t1[:, 1:] == t1[:, :-1])
        assert tie[:, :half - 1].any() and tie[:, half:].any()
        assert tie[:, half - 1].any()           # layers 31 and 32


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [33, 64, 65, 128])
def test_deep_passes_chain_bitwise_twin(cuda, depth):
    """peel_fused at depths whose passes take the deep layout: each pass
    through the kernel and through the twin above the floor of the pass
    before, every output bitwise; the chained radiance and transmittance of
    peel_fused bitwise its chain of twins (impl "torch")."""
    packed, cand, _, pix = deep_inputs(cuda)
    floor = None
    for k in pass_depths(depth):
        sl, last = _pass_bitwise(packed, cand, pix, k, floor)
        floor = (last.contiguous(), sl[:, -1].contiguous())
    assert (sl[:, -1] >= 0).any()
    got = peel_fused(packed, cand, pix, depth)
    ref = peel_fused(packed, cand, pix, depth, impl="torch")
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


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


@pytest.mark.cuda
def test_render_auto_launches_the_fused_kernel(cuda):
    """On a CUDA scene above 4096 splats ``render(renderer="auto")`` (the
    JAX rule) launches ``peel_fwd.cu`` once a band and never the keys
    kernel; its frame is the keys path's to the image statistic (a t1 tie
    at the last layer may fall the other way)."""
    from rtgs_tpu_torch.ops.peel import peel_keys_cuda
    from rtgs_tpu_torch.render.api import render
    from rtgs_tpu_torch.render.tiled import render_tiled_keys

    g, cam, _, _, _ = _frame(cuda, n=5000)
    kw = dict(depth=16, max_candidates=1024, max_global=64)
    fused0, keys0 = peel_fused_cuda.launches, peel_keys_cuda.launches
    with torch.inference_mode():
        img = render(g, cam, tile_bands=2, **kw)
        ref = render_tiled_keys(g, cam, **kw)
    assert peel_fused_cuda.launches == fused0 + 2
    assert peel_keys_cuda.launches == keys0 + 1
    diff = (img - ref).abs().cpu().numpy()
    assert float(np.quantile(diff, 0.99)) < 5e-4 and diff.max() < 0.12
