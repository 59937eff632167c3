"""The port's primitive math (rtgs_tpu_torch.gaussians, rays, camera) and
its brute-force oracle (rtgs_tpu_torch.render.oracle) against the JAX
package's, on the same inputs made with numpy and passed through
rtgs_tpu_torch.bridge; then the oracle against the float64 golden images
and finite-difference gradients of tests/golden/.

Both packages evaluate the same f32 formulas, summed in the same order
where the formula fixes one, so values agree to a few f32 ulps: 1e-5
relative (2e-5 where a quadratic cancels) unless a test says otherwise.
The analytic cases of tests/test_oracle.py are held to their hand values
too. Against the goldens, the thresholds are those of
tests/test_parity_golden.py."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtgs_tpu import camera as jcamera
from rtgs_tpu import gaussians as JG
from rtgs_tpu import rays as jrays
from rtgs_tpu.render import oracle as joracle
from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.bridge import (camera_from_numpy, gaussians_from_numpy,
                                   rays_from_numpy, rays_to_numpy)
from rtgs_tpu_torch.camera import camera_from_fov, generate_ray_grid
from rtgs_tpu_torch.rays import Rays, new_rays
from rtgs_tpu_torch.render.oracle import (composite_hits, composite_rays,
                                          render_oracle,
                                          render_peeled_reference, topk_hits)
from rtgs_tpu_torch.scene import load_scene, random_scene_arrays

GOLDEN = pathlib.Path(__file__).parent / "golden"
RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scenes(n, extent=1.0, seed=0, scale_range=(0.02, 0.1)):
    fields = random_scene_arrays(n, extent, scale_range, seed=seed)
    return (JG.Gaussians(**{k: jnp.asarray(v) for k, v in fields.items()}),
            gaussians_from_numpy(fields, device="cpu"))


def _random_rays(n, seed=1, spread=3.0):
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    dirs = -origins / np.linalg.norm(origins, axis=-1, keepdims=True)
    return jrays.new_rays(origins, dirs), new_rays(origins, dirs, device="cpu")


# ----- primitive math -----

def test_covariance_and_inverses_match_jax():
    """Σ and R S⁻² Rᵀ agree to 4 f32 ulps of each matrix's largest entry.
    The adjugate inverse of Σ cancels: one ulp of Σ grows by the
    condition number κ = (max scale / min scale)², so it agrees to
    8·2⁻²⁴·κ of the matrix's largest entry."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    s = np.exp(rng.uniform(np.log(0.01), np.log(0.3), (64, 3))).astype(
        np.float32)
    kappa = (s.max(-1) / s.min(-1)) ** 2
    for name in ("covariance", "inv_covariance", "inv_covariance_direct"):
        got = getattr(G, name)(_t(q), _t(s)).numpy()
        ref = np.asarray(getattr(JG, name)(jnp.asarray(q), jnp.asarray(s)))
        assert got.shape == (64, 3, 3)
        rel = (np.abs(got - ref).reshape(64, -1).max(-1)
               / np.abs(ref).reshape(64, -1).max(-1))
        ulps = 2.0**-24 * (8 * kappa if name == "inv_covariance" else 4)
        assert (rel <= ulps).all(), (name, (rel / ulps).max())
    # Σ⁻¹ Σ = I.
    prod = G.inv_covariance(_t(q), _t(s)) @ G.covariance(_t(q), _t(s))
    np.testing.assert_allclose(prod.numpy(), np.broadcast_to(np.eye(3),
                                                             prod.shape),
                               atol=1e-3)


def test_new_gaussians_defaults_match_jax():
    means = [[0.0, 0.0, -5.0], [1.0, 2.0, 3.0]]
    tg, jg = G.new_gaussians(means, device="cpu"), JG.new_gaussians(means)
    for f in G.FIELDS:
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    tg = G.new_gaussians(means, opacities=[0.3, 0.4], device="cpu")
    np.testing.assert_array_equal(tg.opacities.numpy(),
                                  np.float32([0.3, 0.4]))


def test_hit_matches_jax():
    """Random rays against random splats: hits, misses and the t2 = inf of
    a miss, in the same places as JAX, and the same depths."""
    jg, tg = _scenes(60, seed=4, scale_range=(0.1, 0.6))
    jr, tr = _random_rays(40)
    cov = JG.inv_covariance(jg.quats, jg.scales)
    j1, j2 = JG.hit(cov, jg.means, jr.origins[:, None], jr.directions[:, None])
    t1, t2 = G.hit(_t(cov), tg.means, tr.origins[:, None],
                   tr.directions[:, None])
    j1, j2 = np.asarray(j1), np.asarray(j2)
    for got, ref in ((t1.numpy(), j1), (t2.numpy(), j2)):
        fin = np.isfinite(ref)
        assert 0.05 < fin.mean() < 0.95            # both hits and misses
        np.testing.assert_array_equal(np.isfinite(got), fin)
        np.testing.assert_allclose(got[fin], ref[fin], rtol=2e-5, atol=2e-5)


def test_hit_tangent_and_miss_semantics_and_gradient():
    """Δ == 0 exactly (Σ⁻¹ = 0.75·I, ray at distance 2 from the center)
    gives (−B/2A, inf); a ray farther out misses with (inf, inf); a ray
    through the center hits twice. The gradient of the finite t1 is
    finite everywhere and equals JAX's."""
    cov = np.broadcast_to(0.75 * np.eye(3, dtype=np.float32), (3, 3, 3))
    means = np.array([[0.0, 0.0, -5.0]] * 3, np.float32)
    origins = np.array([[2.0, 0, 0], [3.0, 0, 0], [0.0, 0, 0]], np.float32)
    dirs = np.array([[0.0, 0, -1]] * 3, np.float32)
    t1, t2 = G.hit(_t(cov), _t(means), _t(origins), _t(dirs))
    assert t1[0] == 5.0 and torch.isinf(t2[0])               # tangent
    assert torch.isinf(t1[1]) and torch.isinf(t2[1])         # miss
    assert torch.isfinite(t1[2]) and torch.isfinite(t2[2])   # two hits

    def jloss(m):
        a, b = JG.hit(jnp.asarray(cov), m, jnp.asarray(origins),
                      jnp.asarray(dirs))
        return (jnp.sum(jnp.where(jnp.isfinite(a), a, 0.0))
                + jnp.sum(jnp.where(jnp.isfinite(b), b, 0.0)))

    m = _t(means).requires_grad_()
    a, b = G.hit(_t(cov), m, _t(origins), _t(dirs))
    (torch.where(torch.isfinite(a), a, 0.0).sum()
     + torch.where(torch.isfinite(b), b, 0.0).sum()).backward()
    ref = np.asarray(jax.grad(jloss)(jnp.asarray(means)))
    assert torch.isfinite(m.grad).all()
    np.testing.assert_allclose(m.grad.numpy(), ref, rtol=RTOL, atol=1e-6)


def test_eval_sh_and_eval_gaussian_match_jax():
    rng = np.random.default_rng(3)
    n = 50
    sh = rng.standard_normal((n, 15, 3)).astype(np.float32)
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    unit = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        G.eval_sh(_t(sh), _t(unit)).numpy(),
        np.asarray(JG.eval_sh(jnp.asarray(sh), jnp.asarray(unit))),
        rtol=RTOL, atol=1e-6)
    jg, tg = _scenes(n, seed=5)
    cov = np.asarray(JG.inv_covariance(jg.quats, jg.scales))
    pos = (np.asarray(jg.means)
           + 0.05 * rng.standard_normal((n, 3))).astype(np.float32)
    rgb, alpha = G.eval_gaussian(_t(cov), tg.means, tg.colors, tg.opacities,
                                 tg.sh, _t(pos), _t(dirs))
    jrgb, jalpha = JG.eval_gaussian(jnp.asarray(cov), jg.means, jg.colors,
                                    jg.opacities, jg.sh, jnp.asarray(pos),
                                    jnp.asarray(dirs))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("offset", [None, (0.25, -0.4)])
def test_generate_ray_grid_matches_jax(offset):
    jcam = jcamera.camera_from_fov([0.3, -0.2, 2.0], [0.1, 0.2, 0.0, 0.97],
                                   (24, 16), 60.0)
    jr = jcamera.generate_ray_grid(jcam, offset)
    tr = generate_ray_grid(camera_from_numpy(jcam, device="cpu"), offset)
    assert tr.origins.shape == (24, 16, 3) and tr.starts.shape == (24, 16)
    for f, v in rays_to_numpy(tr).items():
        np.testing.assert_allclose(v, np.asarray(getattr(jr, f)), rtol=RTOL,
                                   atol=1e-6, err_msg=f)
    # The bridge carries a bundle across, and Rays.get/reshape agree.
    back = rays_from_numpy(jr, device="cpu")
    flat = back.reshape(24 * 16)
    t = torch.linspace(0.5, 2.0, 24 * 16)
    np.testing.assert_allclose(
        flat.get(t).numpy(),
        np.asarray(jr.reshape(24 * 16).get(jnp.asarray(t.numpy()))),
        rtol=RTOL, atol=1e-6)


# ----- the oracle: the cases of tests/test_oracle.py -----

def _both_composite(means, rays_o, rays_d, depth, starts=None, **fields):
    jg = JG.new_gaussians(means, **fields)
    tg = G.new_gaussians(means, **fields, device="cpu")
    jr = jrays.new_rays(rays_o, rays_d, starts)
    tr = new_rays(rays_o, rays_d, starts, device="cpu")
    rad_j, tr_j = joracle.composite_rays(jg, jr, depth=depth)
    rad_t, tr_t = composite_rays(tg, tr, depth=depth)
    np.testing.assert_allclose(rad_t.numpy(), np.asarray(rad_j), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(tr_t.numpy(), np.asarray(tr_j), rtol=RTOL,
                               atol=1e-6)
    return rad_t.numpy(), tr_t.numpy()


AXIS = dict(rays_o=[[0.0, 0.0, 0.0]], rays_d=[[0.0, 0.0, -1.0]])


def test_single_gaussian_on_and_off_axis():
    rad, tr = _both_composite([[0.0, 0.0, -5.0]], depth=4,
                              colors=[[0.2, 0.5, 0.9]], opacities=[0.6],
                              **AXIS)
    np.testing.assert_allclose(rad[0], 0.6 * np.array([0.2, 0.5, 0.9]),
                               rtol=1e-5)
    np.testing.assert_allclose(tr[0], 0.4, rtol=1e-5)
    rad, tr = _both_composite([[1.0, 0.0, -5.0]], depth=4, opacities=[0.8],
                              **AXIS)
    alpha = 0.8 * np.exp(-1.0)
    np.testing.assert_allclose(tr[0], 1 - alpha, rtol=1e-5)
    np.testing.assert_allclose(rad[0], alpha * np.array([1.0, 0.0, 1.0]),
                               rtol=1e-5)


@pytest.mark.parametrize("order", [[0, 1], [1, 0]])
def test_two_gaussians_ordering(order):
    means = np.array([[0.0, 0.0, -3.0], [0.0, 0.0, -7.0]])[order]
    colors = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])[order]
    rad, tr = _both_composite(means, depth=4, colors=colors,
                              opacities=[0.5, 0.5], **AXIS)
    np.testing.assert_allclose(rad[0], [0.5, 0.25, 0.0], atol=1e-5)
    np.testing.assert_allclose(tr[0], 0.25, rtol=1e-5)


def test_depth_truncation_and_padding_to_k():
    """depth 1 composites only the nearest layer; with 2 splats and K 4
    the lists are padded (t1 inf, α 0, rgb 0)."""
    kw = dict(colors=[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
              opacities=[0.5, 0.5], **AXIS)
    means = [[0.0, 0.0, -3.0], [0.0, 0.0, -7.0]]
    rad, _ = _both_composite(means, depth=1, **kw)
    np.testing.assert_allclose(rad[0], [0.5, 0.0, 0.0], atol=1e-6)
    t1, alpha, rgb = topk_hits(G.new_gaussians(means, colors=kw["colors"],
                                               opacities=kw["opacities"],
                                               device="cpu"),
                               new_rays(AXIS["rays_o"], AXIS["rays_d"],
                                        device="cpu"), 4)
    assert t1.shape == (1, 4) and rgb.shape == (1, 4, 3)
    assert torch.isinf(t1[0, 2:]).all() and (alpha[0, 2:] == 0).all()
    assert (rgb[0, 2:] == 0).all() and (t1[0, 0] < t1[0, 1])


@pytest.mark.parametrize("z", [5.0, -0.5])
def test_behind_and_straddling_origin_excluded(z):
    """A Gaussian behind the origin, or straddling it (t1 < 0 < t2), is
    rejected: t1 must exceed start = 0."""
    rad, tr = _both_composite([[0.0, 0.0, z]], depth=4, **AXIS)
    np.testing.assert_allclose(rad[0], 0.0, atol=1e-7)
    np.testing.assert_allclose(tr[0], 1.0)


def test_ray_start_and_end_are_open():
    """A ray whose start lies past the near splat sees only the far one."""
    rad, _ = _both_composite([[0.0, 0.0, -3.0], [0.0, 0.0, -7.0]], depth=4,
                             starts=[4.0],
                             colors=[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                             opacities=[0.5, 0.5], **AXIS)
    np.testing.assert_allclose(rad[0], [0.0, 0.5, 0.0], atol=1e-6)


def test_mask_excludes_padding():
    fields = random_scene_arrays(37, 1.0, seed=6)
    padded = {k: np.concatenate([v, np.zeros((27,) + v.shape[1:],
                                             np.float32)])
              for k, v in fields.items()}
    padded["scales"][37:] = 1.0
    padded["quats"][37:, 3] = 1.0
    rays = new_rays(np.tile([0, 0, 3.0], (8, 1)), np.tile([0, 0, -1.0],
                                                          (8, 1)),
                    device="cpu")
    r1, t1 = composite_rays(gaussians_from_numpy(fields, device="cpu"), rays,
                            depth=8)
    r2, t2 = composite_rays(gaussians_from_numpy(padded, device="cpu"), rays,
                            depth=8)
    np.testing.assert_allclose(r1.numpy(), r2.numpy(), atol=1e-6)
    np.testing.assert_allclose(t1.numpy(), t2.numpy(), atol=1e-6)


def test_topk_equals_literal_peel_and_jax():
    """One top-K pass equals the reference's iterative peel, in the port,
    and both equal the JAX oracle, on a random scene from random
    viewpoints."""
    jg, tg = _scenes(100, seed=7)
    jr, tr = _random_rays(32, seed=8)
    r_topk, t_topk = composite_rays(tg, tr, depth=16)
    r_peel, t_peel = render_peeled_reference(tg, tr, depth=16)
    np.testing.assert_allclose(r_topk.numpy(), r_peel.numpy(), atol=2e-5)
    np.testing.assert_allclose(t_topk.numpy(), t_peel.numpy(), atol=2e-5)
    r_j, t_j = joracle.composite_rays(jg, jr, depth=16)
    np.testing.assert_allclose(r_topk.numpy(), np.asarray(r_j), atol=2e-5)
    np.testing.assert_allclose(t_topk.numpy(), np.asarray(t_j), atol=2e-5)
    rj_peel, _ = joracle.render_peeled_reference(jg, jr, depth=16)
    np.testing.assert_allclose(r_peel.numpy(), np.asarray(rj_peel), atol=2e-5)


def test_ties_go_to_the_lower_index():
    """Two identical splats tie exactly in t1: the lower index takes the
    nearer layer, as lax.top_k orders them."""
    means = [[0.0, 0.0, -5.0], [0.0, 0.0, -5.0]]
    colors = [[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    g = G.new_gaussians(means, colors=colors, opacities=[0.5, 0.5],
                        device="cpu")
    rays = new_rays(AXIS["rays_o"], AXIS["rays_d"], device="cpu")
    _, _, rgb = topk_hits(g, rays, 2)
    np.testing.assert_array_equal(rgb[0].numpy(), colors)
    _both_composite(means, depth=2, colors=colors, opacities=[0.5, 0.5],
                    **AXIS)


def test_sh_view_dependence():
    sh = np.zeros((1, 15, 3), np.float32)
    sh[0, 0, 0] = 1.0
    d = np.array([0.0, 0.6, -0.8], np.float32)
    rad, _ = _both_composite([[0.0, 0.0, 0.0]], depth=1,
                             rays_o=[(-5 * d).tolist()], rays_d=[d.tolist()],
                             colors=[[0.3, 0.3, 0.3]], sh=sh)
    np.testing.assert_allclose(rad[0, 0], 0.3 + 0.5 * G.C_0 * 0.6, rtol=1e-5)
    np.testing.assert_allclose(rad[0, 1], 0.3, rtol=1e-5)


def test_render_oracle_full_frame_matches_jax():
    """Shape, chunk invariance (7-pixel chunks, bitwise: rays are
    independent) and the JAX oracle's frame, with and without a subpixel
    offset."""
    jg, tg = _scenes(50, extent=0.5, seed=9)
    jcam = jcamera.new_camera([0, 0, 2.0], [0, 0, 0, 1], (16, 12),
                              (10.0, 10.0))
    tcam = camera_from_numpy(jcam, device="cpu")
    img = render_oracle(tg, tcam, depth=8)
    assert img.shape == (16, 12, 3) and torch.isfinite(img).all()
    assert torch.equal(render_oracle(tg, tcam, depth=8, pixel_chunk=7), img)
    np.testing.assert_allclose(
        img.numpy(), np.asarray(joracle.render_oracle(jg, jcam, depth=8)),
        atol=2e-5)
    off = (0.3, -0.2)
    np.testing.assert_allclose(
        render_oracle(tg, tcam, depth=8, pixel_offset=off).numpy(),
        np.asarray(joracle.render_oracle(jg, jcam, depth=8,
                                         pixel_offset=jnp.asarray(off))),
        atol=2e-5)


def test_gradients_match_jax():
    """Autograd through the whole composite: finite for every field, and
    equal to jax.grad of the same loss (the same f32 arithmetic, so to
    1e-4 of each field's largest entry)."""
    jg, tg = _scenes(20, extent=0.5, seed=10)
    rng = np.random.default_rng(11)
    origins = np.tile([0, 0, 2.0], (16, 1)) + 0.2 * rng.standard_normal(
        (16, 3))
    jr = jrays.new_rays(origins, np.tile([0, 0, -1.0], (16, 1)))
    tr = rays_from_numpy(jr, device="cpu")
    params = {f: getattr(tg, f).clone().requires_grad_()
              for f in G.FIELDS if f != "mask"}
    rad, _ = composite_rays(G.Gaussians(mask=tg.mask, **params), tr, depth=8)
    (rad ** 2).sum().backward()
    grads_j = jax.grad(lambda g: jnp.sum(joracle.composite_rays(
        g, jr, depth=8)[0] ** 2))(jg)
    for f, p in params.items():
        ref = np.asarray(getattr(grads_j, f))
        assert torch.isfinite(p.grad).all(), f
        scale = np.abs(ref).max()
        if f in ("colors", "opacities", "means"):
            assert scale > 0, f
        np.testing.assert_allclose(p.grad.numpy() / max(scale, 1e-12),
                                   ref / max(scale, 1e-12), atol=1e-4,
                                   err_msg=f)


def test_composite_hits_gradient_at_opaque_layers():
    """The exclusive cumprod's gradient with α = 1 layers (a zero factor
    in the product) equals jax.grad's, and is finite."""
    rng = np.random.default_rng(12)
    alpha = rng.uniform(0.1, 0.9, (6, 5)).astype(np.float32)
    alpha[0, 0] = alpha[1, 2] = alpha[2, 4] = 1.0
    alpha[3, 1] = alpha[3, 3] = 1.0
    alpha[4] = 0.0
    rgb = rng.uniform(0, 1, (6, 5, 3)).astype(np.float32)
    t1 = np.sort(rng.uniform(1, 5, (6, 5)), -1).astype(np.float32)
    w_rad = rng.standard_normal((6, 3)).astype(np.float32)
    w_tr = rng.standard_normal((6,)).astype(np.float32)

    def jloss(a, c):
        rad, tr = joracle.composite_hits(jnp.asarray(t1), a, c)
        return jnp.sum(rad * w_rad) + jnp.sum(tr * w_tr)

    ga_j, gc_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(alpha),
                                                 jnp.asarray(rgb))
    a, c = _t(alpha).requires_grad_(), _t(rgb).requires_grad_()
    rad, tr = composite_hits(_t(t1), a, c)
    ((rad * _t(w_rad)).sum() + (tr * _t(w_tr)).sum()).backward()
    assert torch.isfinite(a.grad).all() and torch.isfinite(c.grad).all()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ga_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(gc_j), rtol=1e-5,
                               atol=1e-6)


# ----- the oracle against the float64 goldens -----

def _golden_camera(z, res=None):
    return camera_from_fov(np.asarray(z["cam_pos"], np.float32),
                           np.asarray(z["cam_rot"], np.float32),
                           tuple(int(v) for v in (res if res is not None
                                                  else z["res"])),
                           float(z["fov_deg"]), device="cpu")


def assert_golden_close(actual, golden, tag, q=0.995, qtol=2e-3,
                        maxtol=0.05):
    """tests/test_parity_golden.py's statistic: the bulk tightly, a tiny
    tail of silhouette pixels looser."""
    diff = np.abs(_np(actual) - golden)
    scale = max(1.0, float(np.abs(golden).max()))
    qv = np.quantile(diff, q) / scale
    assert qv < qtol, f"{tag}: {q}-quantile rel diff {qv:.2e}"
    assert diff.max() / scale < maxtol, (
        f"{tag}: max rel diff {diff.max() / scale:.2e}")


GOLDEN_CASES = [("golden_fixture.npz", "ref_test.ply"),
                ("golden_synth.npz", "synthetic120.ply")]


@pytest.mark.parametrize("npz,ply", GOLDEN_CASES)
@pytest.mark.parametrize("chunk", [None, 500])
def test_render_oracle_matches_golden(npz, ply, chunk):
    z = np.load(GOLDEN / npz)
    scale = float(z["scale"]) if "scale" in z else 1.0
    g = load_scene(GOLDEN / ply, scale=scale, sh_layout="reference_flat",
                   device="cpu")
    img = render_oracle(g, _golden_camera(z), depth=int(z["depth"]),
                        pixel_chunk=chunk)
    assert_golden_close(img, z["img"], f"{npz}/oracle/{chunk}")


def test_oracle_gradients_match_golden_finite_differences():
    """Autograd of the port's oracle against the reference-code central
    differences, at tests/test_parity_golden.py's tolerance
    1e-4 + 2e-2·|fd|."""
    z = np.load(GOLDEN / "golden_grads.npz")
    g = load_scene(GOLDEN / "synthetic120.ply", sh_layout="reference_flat",
                   device="cpu")
    cam = _golden_camera(z, res=(32, 24))
    leaves = {f: getattr(g, f).clone().requires_grad_()
              for f in ("means", "scales", "colors", "opacities", "sh",
                        "quats")}
    quats = leaves["quats"] / torch.linalg.norm(leaves["quats"], dim=-1,
                                                keepdim=True)
    gg = G.Gaussians(means=leaves["means"], quats=quats,
                     scales=leaves["scales"], colors=leaves["colors"],
                     opacities=leaves["opacities"], sh=leaves["sh"],
                     mask=g.mask)
    loss = (_t(z["weights"]) * render_oracle(gg, cam,
                                             depth=int(z["depth"]))).sum()
    loss.backward()
    by_field = {f: leaves[f].grad.numpy() for f in leaves}
    by_field["quat_renorm"] = by_field.pop("quats")
    fd = z["fd"]
    for k, field in enumerate(str(f) for f in z["probe_fields"]):
        if field == "quat_renorm":
            gi, ci = (int(v) for v in z["probe_quat"][k])
            ours = by_field[field][gi, ci]
        else:
            ours = by_field[field].reshape(-1)[int(z["probe_idx"][k])]
        tol = 1e-4 + 2e-2 * abs(fd[k])
        assert abs(ours - fd[k]) < tol, (k, field, ours, fd[k])
    assert np.abs(fd).max() > 1e-4


def test_rays_defaults():
    r = new_rays([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]], [[0.0, 0.0, -1.0]] * 2,
                 device="cpu")
    assert isinstance(r, Rays)
    assert (r.starts == 0).all() and torch.isinf(r.ends).all()
    np.testing.assert_array_equal(
        r.get(torch.tensor([2.0, 3.0])).numpy(), [[0, 0, -2.0], [1, 0, -3.0]])
