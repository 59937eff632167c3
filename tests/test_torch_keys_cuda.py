"""The Hopper keys kernel (rtgs_tpu_torch/ops/csrc/keys.cu) against its
plain torch twin, on the card. Imports no JAX, so it runs where only the
port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_keys_cuda.py

Both evaluate t1 with the same f32 operations in the same order and the
kernel is built without FMA contraction, so t1 and ids must be bitwise
equal; with chunk_lb (exact early exit) the kernel must be bitwise equal
to itself without it. The kernel's f32 screen rejects a pair only when its
float64 Δ is provably negative, so it changes no bit: held here on a scene
of needles and discs seen from 0.2 and from 50 units away, where the
entry depth cancels hardest, and by the screen's counters."""

import numpy as np
import pytest
import torch

from rtgs_tpu_torch.camera import camera_from_fov
from rtgs_tpu_torch.ops.peel import (CHUNK, MAX_DEPTH, _counts, _safe_ids,
                                     entry_depth, peel_keys, peel_keys_cuda,
                                     peel_keys_torch, screen_rejects)
from rtgs_tpu_torch.render.binning import tile_candidates
from rtgs_tpu_torch.render.tiled import (_tile_pixel_features, pack_features,
                                         precompute_features,
                                         render_tiled_keys)
from rtgs_tpu_torch.scene import anisotropic_scene, random_scene
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


def _anisotropic_frame(device, gap, fov, n=20_000, res=(64, 48)):
    """Needles and discs in a cube of half-size 0.5, the camera ``gap``
    units from the cube's circumscribed sphere."""
    g = anisotropic_scene(n, extent=0.5, seed=4, device=device)
    pos, rot, _, _ = orbit_camera_pose(0.3, 1.2, 0.5 * 3 ** 0.5 + gap,
                                       np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    cam = camera_from_fov(pos, rot, res, fov, device=device)
    b = tile_candidates(g, cam, max_candidates=2048, max_global=512,
                        chunk=CHUNK)
    packed = pack_features(precompute_features(g, cam))
    return b, packed, _tile_pixel_features(cam, (16, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("gap,fov", [(0.2, 60.0), (50.0, 2.0)])
@pytest.mark.parametrize("depth", [8, 16])
def test_kernel_matches_twin_on_anisotropic_splats(cuda, gap, fov, depth):
    """The full sweep is bitwise the twin's. With chunk_lb it is so on every
    tile whose bounds hold: the f32 feature table loses the definiteness of
    such splats' Σ⁻¹, and t1 from such a row can lie in front of the
    binning's geometric bound, which is then none."""
    b, packed, pix = _anisotropic_frame(cuda, gap, fov)
    cand, lb = b.candidates, b.chunk_lb
    counts = _counts(cand)
    t1_f, sid_f = peel_keys_cuda(packed, cand, counts, torch.zeros_like(lb),
                                 pix, depth)
    t1_k, sid_k = peel_keys_cuda(packed, cand, counts, lb, pix, depth)
    t1_t, sid_t = peel_keys_torch(packed, cand, pix, depth)
    torch.cuda.synchronize()
    assert (sid_f >= 0).any()
    assert torch.equal(sid_f, sid_t) and torch.equal(t1_f, t1_t)
    t, c = cand.shape
    rows = packed[:, :10][_safe_ids(packed, cand)]
    cmin = entry_depth(rows, pix).amin(1).reshape(t, c // CHUNK,
                                                  CHUNK).amin(2)
    suffix = torch.cummin(cmin.flip(1), dim=1).values.flip(1)
    valid = (suffix >= lb[:, :-1]).all(dim=1)
    same = ((sid_k == sid_t) & (t1_k == t1_t)).all(dim=2).all(dim=1)
    assert same[valid].all()


@pytest.mark.cuda
@pytest.mark.parametrize("aniso", [False, True])
def test_screen_counters_match_plain_screen(cuda, aniso):
    """The counting instantiation gives the same result, evaluates every
    (pixel, live candidate) pair of the full sweep, and rejects no hit; its
    rejected count is close to the plain screen's (the two round
    differently: the kernel fuses its multiply-adds)."""
    if aniso:
        b, packed, pix = _anisotropic_frame(cuda, 0.2, 60.0, n=5000)
    else:
        _, _, b, packed, pix = _frame(cuda)
    cand = b.candidates
    counts = _counts(cand)
    zeros = torch.zeros_like(b.chunk_lb)
    counters = torch.zeros(2, dtype=torch.int64, device=cuda)
    t1_c, sid_c = peel_keys_cuda(packed, cand, counts, zeros, pix, 16,
                                 screen_counts=counters)
    t1_k, sid_k = peel_keys_cuda(packed, cand, counts, zeros, pix, 16)
    assert torch.equal(t1_c, t1_k) and torch.equal(sid_c, sid_k)
    rows = packed[:, :10][_safe_ids(packed, cand)]
    live = (cand >= 0)[:, None, :]
    rejected = screen_rejects(rows, pix) & live
    hits = torch.isfinite(entry_depth(rows, pix)) & live
    assert not (rejected & hits).any()
    pairs, n_rej = (int(x) for x in counters)
    assert pairs == int(live.sum()) * pix.shape[1]
    assert n_rej <= pairs - int(hits.sum())
    assert abs(n_rej - int(rejected.sum())) <= 1e-3 * pairs


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
