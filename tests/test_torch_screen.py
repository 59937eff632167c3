"""The keys kernel's f32 screen, through its plain torch version
(rtgs_tpu_torch.ops.peel.screen_margin / screen_rejects), on the CPU.

The screen may reject a (pixel, candidate) pair before the float64 entry
depth runs only if that pair is a miss: it must never reject a pair that
``entry_depth`` accepts, whatever the rows hold, or the kernel's result
would no longer be bitwise the unscreened twin's. And it must reject most
misses at the bench scene's scales, or it is useless. The kernel evaluates
the same predicate with fused multiply-adds; the margin bounds the error of
both evaluations (csrc/peel_common.cuh has the derivation), and the kernel
itself is held bitwise against the unscreened twin on the card
(tests/test_torch_keys_cuda.py, chip_smoke.py phase 3)."""

import math
import pathlib
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rtgs_tpu_torch.camera import camera_from_fov
from rtgs_tpu_torch.ops import peel
from rtgs_tpu_torch.ops.peel import (CHUNK, _safe_ids, entry_depth,
                                     peel_keys_torch, screen_margin,
                                     screen_rejects)
from rtgs_tpu_torch.render.binning import tile_candidates
from rtgs_tpu_torch.render.tiled import (_tile_pixel_features,
                                         direction_features, pack_features,
                                         precompute_features)
from rtgs_tpu_torch.scene import anisotropic_scene, random_scene
from rtgs_tpu_torch.viewer.orbit import orbit_camera_pose

CSRC = (pathlib.Path(peel.__file__).resolve().parent / "csrc"
        / "peel_common.cuh")


def _binned(g, radius, fov=60.0, res=(64, 64), budget=1024):
    pos, rot, _, _ = orbit_camera_pose(0.4, 1.2, radius, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    cam = camera_from_fov(pos, rot, res, fov)
    b = tile_candidates(g, cam, max_candidates=budget, max_global=256,
                        chunk=CHUNK)
    packed = pack_features(precompute_features(g, cam))
    pix = _tile_pixel_features(cam, (16, 16))
    rows = packed[:, :10][_safe_ids(packed, b.candidates)]
    return rows, pix, b.candidates, packed


SCENES = {
    # The bench scene's scales and pose, the CUDA tests' frame, large
    # splats, a camera inside the cloud, and needles and discs (scale ratio
    # ≥ 100 within a splat) from 0.2 and from 50 units away.
    "bench": lambda: _binned(random_scene(
        4000, extent=2.0, scale_range=(0.005, 0.03), seed=0), 5.0),
    "frame": lambda: _binned(random_scene(
        3000, extent=0.6, scale_range=(0.01, 0.06), seed=2), 2.0),
    "large": lambda: _binned(random_scene(
        2000, extent=1.5, scale_range=(0.05, 0.2), seed=1), 5.0),
    "inside": lambda: _binned(random_scene(
        3000, extent=1.0, scale_range=(0.01, 0.1), seed=3), 0.3),
    "needles_near": lambda: _binned(anisotropic_scene(
        5000, extent=0.5, seed=4), 0.5 * 3 ** 0.5 + 0.2),
    "needles_far": lambda: _binned(anisotropic_scene(
        5000, extent=0.5, seed=4), 0.5 * 3 ** 0.5 + 50.0, fov=2.0),
}


def _delta64(rows, pix):
    """Δ of the float64 chain, (T, P, C), in entry_depth's order."""
    m = rows[:, None, :, :10].double()
    q = pix[:, :, None, :9].double()
    a = q[..., 3] * m[..., 0]
    for j in range(1, 6):
        a = a + q[..., 3 + j] * m[..., j]
    b = q[..., 0] * m[..., 6]
    for j in range(1, 3):
        b = b + q[..., j] * m[..., 6 + j]
    b = 2.0 * b
    return b * b - (4.0 * a) * m[..., 9]


def _assert_exact(rows, pix):
    """No rejected pair is a hit, and every rejected pair's float64 Δ is
    negative (what the kernel's skip relies on). Returns (rejected, hits)."""
    rejected = screen_rejects(rows, pix)
    hits = torch.isfinite(entry_depth(rows, pix))
    assert not (rejected & hits).any()
    assert (_delta64(rows, pix)[rejected] < 0).all()
    return rejected, hits


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_screen_rejects_no_hit_on_binned_scenes(scene):
    rows, pix, cand, _ = SCENES[scene]()
    live = (cand >= 0)[:, None, :]
    rejected, hits = _assert_exact(rows, pix)
    assert (hits & live).any()
    # The sentinel row (padding) has c0 = 1e30 and is rejected outright.
    assert rejected[(~live).expand_as(rejected)].all()


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_screened_selection_equals_the_twin(scene):
    """Taking the rejected pairs out of the field, and the candidates that
    every pixel of their tile rejects out of the lists, leaves the twin's
    top-K unchanged, bitwise."""
    rows, pix, cand, packed = SCENES[scene]()
    rejected = screen_rejects(rows, pix)
    t1 = entry_depth(rows, pix)
    assert torch.equal(torch.where(rejected, math.inf, t1), t1)
    thinned = torch.where(rejected.all(dim=1), -1, cand)
    assert (thinned < 0).sum() > (cand < 0).sum()
    t1_k, sid_k = peel_keys_torch(packed, cand, pix, 8)
    t1_s, sid_s = peel_keys_torch(packed, thinned, pix, 8)
    assert (sid_k >= 0).any()
    assert torch.equal(sid_s, sid_k) and torch.equal(t1_s, t1_k)


def test_screen_rejects_most_misses_at_bench_scales():
    rows, pix, cand, _ = SCENES["bench"]()
    live = (cand >= 0)[:, None, :]
    rejected, hits = _assert_exact(rows, pix)
    misses = live & ~hits
    share = float((rejected & misses).sum()) / float(misses.sum())
    assert share > 0.9, share


def _raw_rows(seed, aniso, dist, n=96, p=48):
    """Rows of random ellipsoids with scale ratio ``aniso`` seen from
    ``dist`` mean scales away, and rays scattered around them: float64
    geometry rounded to the f32 tables once, (1, n, 10) and (1, p, 24)."""
    rng = np.random.default_rng(seed)
    quat = rng.standard_normal((n, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    w, x, y, z = quat.T
    rot = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], axis=1).reshape(n, 3, 3)
    scales = np.exp(rng.uniform(0.0, np.log(aniso), (n, 3)))
    scales[:, 0], scales[:, 1] = 1.0, aniso
    minv = np.einsum("nij,nj,nkj->nik", rot, 1.0 / scales ** 2, rot)
    away = rng.standard_normal((n, 3))
    away /= np.linalg.norm(away, axis=1, keepdims=True)
    e = away * dist * np.exp(np.log(scales).mean(1, keepdims=True))
    me = np.einsum("nij,nj->ni", minv, e)
    c0 = np.einsum("ni,ni->n", e, me) - 3.0
    rows = np.concatenate([
        minv[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]], me, c0[:, None]],
        axis=1).astype(np.float32)
    # Rays: toward one of the ellipsoids, off by up to a few of its radii.
    aim = rng.integers(0, n, p)
    d = -e[aim] + rng.standard_normal((p, 3)) * (
        3.0 * scales[aim].max(1, keepdims=True) * rng.uniform(0, 1, (p, 1)))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dirs = torch.from_numpy(d.astype(np.float32))
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    fd, ysh = direction_features(dirs)
    pix = torch.cat([dirs, fd, ysh], dim=-1)
    return torch.from_numpy(rows)[None], pix[None].contiguous(), rng


@settings(max_examples=60, deadline=None, database=None)
@given(seed=st.integers(0, 2**31 - 1),
       aniso=st.floats(1.0, 1e4), dist=st.floats(0.1, 1e3),
       mode=st.sampled_from(["plain", "sentinel", "grazing", "nonfinite"]))
def test_screen_rejects_no_hit_on_raw_rows(seed, aniso, dist, mode):
    rows, pix, rng = _raw_rows(seed, aniso, dist)
    n, p = rows.shape[1], pix.shape[1]
    if mode == "sentinel":
        rows[0, rng.integers(0, n, 8), 9] = 1e30
    elif mode == "grazing":
        # c0 moved so that Δ of one ray lies within ±1e-6·B² of 0.
        q = pix[0, rng.integers(0, p, n)].double()
        m = rows[0].double()
        a = (q[:, 3:9] * m[:, 0:6]).sum(-1)
        b = 2.0 * (q[:, 0:3] * m[:, 6:9]).sum(-1)
        rel = torch.from_numpy(rng.uniform(-1e-6, 1e-6, n))
        rows[0, :, 9] = (b * b * (1.0 - rel) / (4.0 * a)).float()
    elif mode == "nonfinite":
        bad = np.array([np.nan, np.inf, -np.inf, 3e38, -3e38, 1e-42, 0.0],
                       dtype=np.float32)
        for _ in range(12):
            rows[0, rng.integers(0, n), rng.integers(0, 10)] = float(
                rng.choice(bad))
        pix[0, rng.integers(0, p), rng.integers(0, 9)] = float(
            rng.choice(bad))
    rejected, hits = _assert_exact(rows, pix)
    if mode == "plain" and dist > 10.0 and aniso < 10.0:
        assert rejected.any()


def test_margin_is_infinite_where_the_bound_does_not_hold():
    rows, pix, _ = _raw_rows(0, 10.0, 10.0)
    rows[0, 0, 9] = np.inf          # overflow: b̄² + Ā·|c0| is not finite
    rows[0, 1, :6] = 1e30           # Ā·|c0| beyond 2¹²⁰
    rows[0, 1, 9] = 1e10
    rows[0, 2, 7] = np.nan
    margin = screen_margin(rows, pix)
    assert margin.shape == rows.shape[:2]
    assert torch.isinf(margin[0, :3]).all() and (margin[0, :3] > 0).all()
    assert torch.isfinite(margin[0, 3:]).all() and (margin[0, 3:] > 0).all()
    assert not screen_rejects(rows, pix)[0, :, :3].any()
    # A NaN pixel lane makes every margin of its tile +inf.
    pix[0, 5, 4] = np.nan
    assert torch.isinf(screen_margin(rows, pix)).all()
    assert not screen_rejects(rows, pix).any()


def test_margin_scales_with_the_rows():
    """Twice the row, twice A, b and c0: four times the margin (the
    underflow term aside), so the screen is scale-free."""
    rows, pix, _ = _raw_rows(1, 5.0, 50.0)
    m1, m2 = screen_margin(rows, pix), screen_margin(2.0 * rows, pix)
    assert torch.allclose(m2, 4.0 * m1, rtol=1e-5)


def test_constants_are_the_kernels():
    """The plain screen and the CUDA one share their constants."""
    text = CSRC.read_text()

    def const(name):
        m = re.search(rf"constexpr float {name} = ([^;]+);", text)
        return eval(m.group(1).replace("f", ""))  # e.g. "12. * 5.96e-8"

    assert const("kScreenRel") == peel.SCREEN_REL
    assert const("kScreenTiny") == pytest.approx(peel.SCREEN_TINY, rel=1e-6)
    assert const("kScreenMax") == pytest.approx(peel.SCREEN_MAX, rel=1e-6)
    assert np.float32(peel.SCREEN_TINY) > 0       # a subnormal, not 0
