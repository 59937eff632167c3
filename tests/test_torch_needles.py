"""Needle- and disc-shaped splats (scale ratio ≥ 100 within a splat) on the
CPU: the feature table's Σ⁻¹ stays positive definite, ``chunk_lb`` is a
lower bound of the entry depths the float64 chain gives from the f32 table
(what the keys kernel's early exit relies on; the kernel itself is held on
the card, tests/test_torch_keys_cuda.py and chip_smoke.py phase 3), and the
keys render agrees with a float64 oracle.

The port's Σ⁻¹ is the direct form R·S⁻²·Rᵀ
(rtgs_tpu_torch.gaussians.inv_covariance_direct6); the JAX package inverts
the assembled Σ by its adjugate, which loses definiteness on such splats.
That is a deliberate difference: on well-conditioned splats the two agree
to ~cond(Σ)·2⁻²⁴."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtgs_tpu import gaussians as JG
from rtgs_tpu.camera import new_camera as j_new_camera
from rtgs_tpu.render import tiled as JT
from rtgs_tpu_torch import gaussians as TG
from rtgs_tpu_torch.bridge import camera_to_numpy, gaussians_to_numpy
from rtgs_tpu_torch.camera import camera_from_fov
from rtgs_tpu_torch.ops.peel import CHUNK, _safe_ids, entry_depth
from rtgs_tpu_torch.render.binning import tile_candidates
from rtgs_tpu_torch.render.oracle import render_oracle
from rtgs_tpu_torch.render.tiled import (_tile_pixel_features,
                                         entry_lower_bound, pack_features,
                                         precompute_features,
                                         render_tiled_keys)
from rtgs_tpu_torch.scene import anisotropic_scene, random_scene
from rtgs_tpu_torch.viewer.orbit import orbit_camera_pose
from tests._utils import assert_images_close

EXTENT = 0.5
# (gap from the cloud's circumscribed sphere, vertical FOV): chip_smoke.py's
# two anisotropic views.
VIEWS = {"near": (0.2, 60.0), "far": (50.0, 2.0)}


def _camera(view, res=(64, 48)):
    gap, fov = VIEWS[view]
    pos, rot, _, _ = orbit_camera_pose(
        0.4, 1.2, EXTENT * math.sqrt(3.0) + gap, np.zeros(3),
        np.array([0.0, 0.0, 0.0, 1.0]))
    return camera_from_fov(pos, rot, res, fov, device="cpu")


def _needles(n=3000, **kw):
    return anisotropic_scene(n, extent=EXTENT, seed=4, device="cpu", **kw)


def _sym6_minors(m6):
    """Leading principal minors of the packed sym6 rows, in float64."""
    m00, m01, m02, m11, m12, m22 = m6.double().unbind(-1)
    minor2 = m00 * m11 - m01 * m01
    det = (m00 * (m11 * m22 - m12 * m12) - m01 * (m01 * m22 - m12 * m02)
           + m02 * (m01 * m12 - m11 * m02))
    return m00, minor2, det


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_packed_rows_are_positive_definite(view):
    g = _needles()
    packed = pack_features(precompute_features(g, _camera(view)))
    for minor in _sym6_minors(packed[:-1, :6]):
        assert (minor > 0).all()
    # The reference's adjugate form is what loses it.
    old = torch.stack(TG.inv_covariance_packed6(g.quats, g.scales), dim=-1)
    assert any((minor <= 0).any() for minor in _sym6_minors(old))


def _bound_holds(packed, cand, lb, pix):
    """Per tile: chunk_lb[t, c] ≤ every float64-chain t1 of the chunks from
    c on."""
    t, c = cand.shape
    rows = packed[:, :10][_safe_ids(packed, cand)]
    cmin = entry_depth(rows, pix).amin(1).reshape(t, c // CHUNK,
                                                  CHUNK).amin(2)
    suffix = torch.cummin(cmin.flip(1), dim=1).values.flip(1)
    return (suffix >= lb[:, :-1]).all(dim=1)


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_chunk_lb_bounds_the_tables_entry_depths(view):
    g, cam = _needles(), _camera(view)
    packed = pack_features(precompute_features(g, cam))
    pix = _tile_pixel_features(cam, (16, 16))
    kw = dict(max_candidates=3072, max_global=512, chunk=CHUNK)
    b = tile_candidates(g, cam, entry_lb=entry_lower_bound(g, cam, packed),
                        **kw)
    assert int(b.local_overflow) == 0 and int(b.global_overflow) == 0
    assert torch.isfinite(entry_depth(
        packed[:, :10][_safe_ids(packed, b.candidates)], pix)).any()
    assert _bound_holds(packed, b.candidates, b.chunk_lb, pix).all()
    # The bound never changes the lists, only loosens chunk_lb.
    plain = tile_candidates(g, cam, **kw)
    assert torch.equal(plain.candidates, b.candidates)
    assert (b.chunk_lb <= plain.chunk_lb).all()
    if view == "far":
        # The exact ellipsoid's bound is none for the f32 table: from 50
        # units away c0 alone is rounded by thousands of its threshold 3.
        assert not _bound_holds(packed, plain.candidates, plain.chunk_lb,
                                pix).all()


def test_entry_lower_bound_costs_the_bench_scene_little():
    """At the bench scene's scales the proven bound lies a few percent of a
    splat's size in front of depth − √3·s_max, and is a bound."""
    g = random_scene(3000, extent=2.0, scale_range=(0.005, 0.03), seed=0,
                     device="cpu")
    pos, rot, _, _ = orbit_camera_pose(0.4, 1.2, 5.0, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    cam = camera_from_fov(pos, rot, (64, 48), 60.0, device="cpu")
    packed = pack_features(precompute_features(g, cam))
    lb = entry_lower_bound(g, cam, packed)
    depth = ((g.means - cam.position)
             * TG.quat.rot_vec3(cam.rotation, torch.tensor([0.0, 0.0, -1.0]))
             ).sum(-1)
    s_max = g.scales.amax(-1)
    exact = (depth - math.sqrt(3.0) * s_max).clamp(min=0.0)
    gap = (exact - lb) / s_max
    assert (gap > 0).all() and float(gap.median()) < 0.2
    b = tile_candidates(g, cam, max_candidates=1024, max_global=128,
                        chunk=CHUNK, entry_lb=lb)
    pix = _tile_pixel_features(cam, (16, 16))
    assert _bound_holds(packed, b.candidates, b.chunk_lb, pix).all()


def _direct6_numpy(quats, scales):
    """R·S⁻²·Rᵀ in float64 numpy from the f32 inputs, packed sym6."""
    q = quats.astype(np.float64)
    x, y, z, w = q.T
    r = np.stack([
        np.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), w * w - x * x + y * y - z * z,
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  w * w - x * x - y * y + z * z], -1)], -2)
    n = (q * q).sum(-1)                   # the columns of r are |q|² long
    a = r / (scales.astype(np.float64) * (n * n)[:, None])[:, None, :]
    m = a @ a.transpose(0, 2, 1)
    return m.reshape(-1, 9)[:, [0, 1, 2, 4, 5, 8]]


@pytest.mark.parametrize("scene", ["needles", "bench"])
def test_direct_form_against_float64(scene):
    """Each lane within 16·2⁻²⁴ of the splat's largest |Σ⁻¹| entry: the
    rotation's entries and 1/(|q|⁴·s) carry a few roundings each, a product
    of two such factors doubles them, the sum of three terms adds two, all
    of terms below 1/s_min², which the largest entry is at least a third of
    (measured: 11·2⁻²⁴). And the diagonal is never negative."""
    g = (_needles() if scene == "needles" else
         random_scene(3000, extent=2.0, scale_range=(0.005, 0.03), seed=0,
                      device="cpu"))
    got = torch.stack(TG.inv_covariance_direct6(g.quats, g.scales),
                      dim=-1).numpy().astype(np.float64)
    want = _direct6_numpy(g.quats.numpy(), g.scales.numpy())
    err = np.abs(got - want).max(-1) / np.abs(want).max(-1)
    assert err.max() <= 16 * 2.0**-24, err.max()
    assert (got[:, [0, 3, 5]] > 0).all()


def test_direct_form_against_the_jax_adjugate_on_a_conditioned_scene():
    """Scale ratio ≤ 6 (the bench scene's range): the two forms of Σ⁻¹
    agree to 1e-5 of each splat's largest entry (cond(Σ) ≤ 36 times a few
    2⁻²⁴), and the whole feature table to 1e-5 of each lane's scale."""
    g = random_scene(3000, extent=2.0, scale_range=(0.005, 0.03), seed=0,
                     device="cpu")
    arrays = gaussians_to_numpy(g)
    jax_m6 = np.stack([np.asarray(x) for x in JG.inv_covariance_packed6(
        arrays["quats"], arrays["scales"])], axis=-1)
    got = torch.stack(TG.inv_covariance_direct6(g.quats, g.scales),
                      dim=-1).numpy()
    scale = np.abs(jax_m6).max(-1, keepdims=True)
    assert (np.abs(got - jax_m6) / scale).max() <= 1e-5
    cam = _camera("near")
    jf = JT.precompute_features(
        JG.Gaussians(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        _jax_camera(cam))
    tf = precompute_features(g, cam)
    for name in ("m6", "me", "c0"):
        j = np.asarray(getattr(jf, name))[:-1]
        t = getattr(tf, name).numpy()[:-1]
        lane = np.abs(j).reshape(len(j), -1).max(-1)
        rel = np.abs(t - j).reshape(len(j), -1).max(-1) / lane
        assert rel.max() <= 1e-5, (name, rel.max())


def _jax_camera(cam):
    c = camera_to_numpy(cam)
    return j_new_camera(c["position"], c["rotation"], c["buf_size"],
                        c["focal_length"])


def _float64(x):
    """A dataclass of tensors with every floating tensor in float64."""
    return type(x)(**{
        f.name: (v.double() if isinstance(v, torch.Tensor)
                 and v.is_floating_point() else v)
        for f in dataclasses.fields(x)
        for v in [getattr(x, f.name)]})


# (minor range, ratio range, 0.99-quantile and max tolerance). The first is
# tests/_utils.assert_images_close's default gate. At the second, thinner
# and longer, the f32 shading exponent B²/4A − (c0+3) is itself rounded by
# ~2⁻²⁴·|e|²/s_min² ≈ 0.1, so α is off by percents whatever selects the
# winners; with the adjugate Σ⁻¹ the same frame is off by 1e7.
NEEDLE_IMAGES = {
    "ratio100-150": ((2e-3, 4e-3), (100.0, 150.0), 5e-4, 0.12),
    "ratio100-300": ((1e-3, 2e-3), (100.0, 300.0), 1e-2, 0.3),
}


@pytest.mark.parametrize("case", sorted(NEEDLE_IMAGES))
def test_keys_render_of_needles_matches_a_float64_oracle(case):
    """The oracle in float64: in f32 its own Σ⁻¹ (the adjugate) returns NaN
    on such splats."""
    minor, ratio, tol, max_tol = NEEDLE_IMAGES[case]
    g = _needles(1500, minor_range=minor, ratio_range=ratio)
    cam = _camera("near", res=(48, 32))
    with torch.no_grad():
        want = render_oracle(_float64(g), _float64(cam), depth=8)
        got, stats = render_tiled_keys(g, cam, depth=8, max_candidates=1536,
                                       max_global=1536, with_stats=True)
    assert int(stats["local_overflow"]) + int(stats["global_overflow"]) == 0
    assert torch.isfinite(got).all() and float(want.max()) > 0.05
    assert_images_close(got.numpy(), want.float().numpy(), tol=tol,
                        max_tol=max_tol, err_msg=case)
