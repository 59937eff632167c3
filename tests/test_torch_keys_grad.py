"""The keys path's backward in the port (rtgs_tpu_torch.render.tiled:
shade_winners_kp as an autograd Function, render_tiled_keys with per-band
recomputation, training and the CLI through them) against the JAX package
on the same inputs, made with numpy and passed through
rtgs_tpu_torch.bridge.

Tolerances. The VJP of shade_winners_kp sums each splat's winner
cotangents in another order than either JAX form (scatter-add, or the
mask-matmul with segment_sum): per feature lane rtol 1e-5 and atol 1e-6 of
the lane's largest entry. Scene gradients pass through the chain from the
f32 table to rotations and scales, which amplifies rounding ~10³-fold (the
shading exponent cancels), so they are held by quantile as
tests/test_torch_render_pallas.py holds the fused path's, and banded
against unbanded in float64."""

import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtgs_tpu import gaussians as JG
from rtgs_tpu.camera import camera_from_fov
from rtgs_tpu.config import TrainConfig as JTrainConfig
from rtgs_tpu.ops.peel import CHUNK as J_CHUNK
from rtgs_tpu.ops.peel import peel_keys as j_peel_keys
from rtgs_tpu.render import tiled as jtiled
from rtgs_tpu.render.binning import tile_candidates as j_tile_candidates
from rtgs_tpu.train import solver as jsolver
from rtgs_tpu.viewer.orbit import orbit_camera_pose
from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.__main__ import main
from rtgs_tpu_torch.bridge import (adam_state_from_optax, camera_from_numpy,
                                   gaussians_from_numpy, params_from_numpy)
from rtgs_tpu_torch.config import TrainConfig
from rtgs_tpu_torch.render import tiled as ttiled
from rtgs_tpu_torch.scene import random_scene, random_scene_arrays, save_scene
from rtgs_tpu_torch.train import solver as tsolver
from tests._utils import assert_images_close

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRAD_FIELDS = ("means", "quats", "scales", "colors", "opacities", "sh")


def _cams(res, theta=0.3, r=3.0):
    pos, rot, _, _ = orbit_camera_pose(theta, 1.2, r, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    jcam = camera_from_fov(pos, rot, res, 60.0)
    return jcam, camera_from_numpy(jcam, device="cpu")


def _jscene(fields):
    return JG.Gaussians(**{k: jnp.asarray(v) for k, v in fields.items()})


# ----- the VJP of shade_winners_kp -----

@functools.cache
def _shade_inputs(n=800, res=(32, 32), depth=8, extent=0.8, seed=5):
    """packed, winner ids, pix and the candidate lists of one small frame,
    from the JAX package's binning and keys stage, as numpy (read-only:
    the tests share them)."""
    fields = random_scene_arrays(n, extent, (0.02, 0.1), seed=seed)
    jg = _jscene(fields)
    jcam, _ = _cams(res)
    b = j_tile_candidates(jg, jcam, tile=(16, 16), max_candidates=256,
                          max_global=32, chunk=J_CHUNK)
    packed = jtiled.pack_features(jtiled.precompute_features(jg, jcam))
    pix = jtiled._tile_pixel_features(jcam, (16, 16))
    _t1, sid = j_peel_keys(packed, b.candidates, pix, depth,
                           chunk_lb=b.chunk_lb, out_layout="kp")
    return tuple(np.asarray(x) for x in (packed, sid, pix, b.candidates))


def _port_vjp(packed, sid, pix, cots):
    p = torch.from_numpy(np.array(packed)).requires_grad_()
    sid_t = torch.from_numpy(
        np.where(np.isfinite(sid), sid, -1).astype(np.int32))
    outs = ttiled.shade_winners_kp(p, sid_t, torch.from_numpy(np.array(pix)))
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cots])
    return [o.detach().numpy() for o in outs], p.grad.numpy()


@pytest.mark.parametrize("with_cand_sid", [False, True])
def test_shade_vjp_matches_jax(with_cand_sid):
    packed, sid, pix, cand = _shade_inputs()
    rng = np.random.default_rng(1)
    cots = [rng.standard_normal(sid.shape).astype(np.float32)
            for _ in range(4)]
    cand_sid = jnp.asarray(cand) if with_cand_sid else None
    outs_j, vjp = jax.vjp(
        lambda p: jtiled.shade_winners_kp(p, jnp.asarray(sid),
                                          jnp.asarray(pix), cand_sid),
        jnp.asarray(packed))
    (dp_j,) = vjp(tuple(jnp.asarray(c) for c in cots))
    dp_j = np.asarray(dp_j)
    outs_t, dp_t = _port_vjp(packed, sid, pix, cots)

    vacant = ~np.isfinite(sid)
    assert 0.05 < vacant.mean() < 0.95          # both kinds of layer
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    n = packed.shape[0] - 1
    scale = np.abs(dp_j[:n]).max(axis=0)                     # per lane
    assert (scale[:59] > 0).all() and (scale[59:] == 0).all()
    err = np.abs(dp_t[:n] - dp_j[:n])
    assert (err <= 1e-5 * np.abs(dp_j[:n]) + 1e-6 * scale).all(), (
        err / (scale + 1e-30)).max()
    # The sentinel row: the port drops vacant winners, so it is exactly 0,
    # as the mask-matmul form leaves it (the scatter form adds the vacant
    # layers' color cotangents there; nobody reads that row).
    assert (dp_t[n] == 0).all()
    if with_cand_sid:
        assert (dp_j[n] == 0).all()


def test_shade_backward_saves_no_row_gather():
    """The Function's residuals are its three inputs: nothing of size
    (T, K, P, 64) is kept for the backward."""
    packed, sid, pix, _ = _shade_inputs()
    p = torch.from_numpy(np.array(packed)).requires_grad_()
    sid_t = torch.from_numpy(
        np.where(np.isfinite(sid), sid, -1).astype(np.int32))
    alpha, *_ = ttiled.shade_winners_kp(p, sid_t,
                                        torch.from_numpy(np.array(pix)))
    saved = alpha.grad_fn.saved_tensors
    assert [tuple(s.shape) for s in saved] == [
        packed.shape, sid.shape, pix.shape]


def test_vacant_winners_get_zero_gradient():
    """A pixel with fewer than K hits: its vacant layers shade the sentinel
    row with α = 0; their cotangents, however large, reach no row."""
    rng = np.random.default_rng(3)
    packed = rng.uniform(0.5, 1.5, (4, 64)).astype(np.float32)
    packed[3] = 0.0
    packed[3, [0, 3, 5]] = 1.0
    packed[3, 9] = 1e30                                    # the sentinel
    pix = rng.uniform(-1, 1, (1, 4, 24)).astype(np.float32)
    sid = np.full((1, 3, 4), np.inf, np.float32)           # K 3, P 4
    sid[0, 0, :2] = 1.0                                    # one hit, 2 pixels
    cots = [np.full(sid.shape, 1e6, np.float32) for _ in range(4)]
    outs, dp = _port_vjp(packed, sid, pix, cots)
    vac = ~np.isfinite(sid)
    assert (outs[0][vac] == 0).all()
    assert (dp[[0, 2, 3]] == 0).all() and np.abs(dp[1]).max() > 0
    # With every layer vacant the whole gradient is exactly zero.
    _, dp0 = _port_vjp(packed, np.full_like(sid, np.inf), pix, cots)
    assert (dp0 == 0).all()


# ----- render_tiled_keys: image and scene gradients -----

KW = dict(depth=8, tile=(16, 16), max_candidates=256, max_global=32)


def test_render_matches_jax():
    fields = random_scene_arrays(2000, 1.0, (0.02, 0.1), seed=11)
    jcam, tcam = _cams((64, 48))
    img_j = jtiled.render_tiled_keys(_jscene(fields), jcam, **KW)
    g = gaussians_from_numpy(fields, device="cpu")
    g = dataclasses.replace(g, means=g.means.clone().requires_grad_())
    img_t = ttiled.render_tiled_keys(g, tcam, **KW)
    assert img_t.requires_grad and img_t.shape == (64, 48, 3)
    assert_images_close(img_t.detach().numpy(), np.asarray(img_j))
    banded = ttiled.render_tiled_keys(g, tcam, tile_bands=3, **KW)
    assert torch.equal(banded, img_t)


def _port_scene_grads(fields, tcam, kw, dtype=torch.float32,
                      render=ttiled.render_tiled_keys):
    leaves = {f: torch.from_numpy(np.array(fields[f])).to(dtype)
              .requires_grad_() for f in GRAD_FIELDS}
    g = G.Gaussians(mask=torch.from_numpy(np.array(fields["mask"])),
                    **leaves)
    if dtype != torch.float32:
        tcam = dataclasses.replace(
            tcam, position=tcam.position.to(dtype),
            rotation=tcam.rotation.to(dtype),
            focal_length=tcam.focal_length.to(dtype))
    (render(g, tcam, **kw) ** 2).sum().backward()
    return {f: leaves[f].grad.double().numpy() for f in GRAD_FIELDS}


def _q99(got, ref):
    rel = np.abs(got - ref) / (np.abs(ref).max() + 1e-8)
    return np.quantile(rel, 0.99), rel.max()


GRAD_KW = dict(depth=8, tile=(8, 8), max_candidates=128, max_global=16)


@pytest.mark.parametrize("bands", [None, 2])
def test_scene_gradients_match_jax(bands):
    """Binning → packing → keys → shading → composite, differentiated end
    to end, against jax.grad through the JAX render_tiled_keys; each
    package also against the port's float64 gradient. Bounds as in
    tests/test_torch_render_pallas.py: q99 < 5e-3 and max < 0.2 of the
    field's largest entry."""
    fields = random_scene_arrays(60, 0.8, (0.02, 0.1), seed=4)
    jcam, tcam = _cams((16, 16))
    kw = dict(GRAD_KW, tile_bands=bands)
    gj = jax.grad(lambda g: jnp.sum(
        jtiled.render_tiled_keys(g, jcam, **kw) ** 2))(_jscene(fields))
    gj = {f: np.asarray(getattr(gj, f), np.float64) for f in GRAD_FIELDS}
    g32 = _port_scene_grads(fields, tcam, kw)
    g64 = _port_scene_grads(fields, tcam, kw, dtype=torch.float64)
    for name in GRAD_FIELDS:
        assert np.isfinite(g32[name]).all(), name
        assert np.abs(gj[name]).max() > 0, name
        for label, got, ref in (("port-jax", g32[name], gj[name]),
                                ("jax-f64", gj[name], g64[name]),
                                ("port-f64", g32[name], g64[name])):
            q, worst = _q99(got, ref)
            assert q < 5e-3 and worst < 0.2, (name, label, q, worst)


def test_keys_gradients_match_tiled():
    """The port's counterpart of tests/test_keys_path.py::
    test_keys_gradients_match_tiled: the hand-written backward of the keys
    path against torch autograd through the all-candidates ``tiled`` path
    (the same winners: both order by the float64 t1), with its bounds."""
    fields = random_scene_arrays(200, 1.0, (0.02, 0.1), seed=0)
    _, tcam = _cams((32, 32))
    kw = dict(depth=8, tile=(16, 16), max_candidates=256, max_global=32)
    gk = _port_scene_grads(fields, tcam, kw)
    gt = _port_scene_grads(fields, tcam, kw, render=ttiled.render_tiled)
    for name in GRAD_FIELDS:
        assert np.isfinite(gk[name]).all(), name
        q, worst = _q99(gk[name], gt[name])
        assert q < 5e-3 and worst < 5e-2, (name, q, worst)


def test_banded_gradients_match_unbanded():
    """The port's counterpart of tests/test_keys_path.py::
    test_banded_gradients_match_unbanded: banding partitions the tiles and
    recomputes each band in the backward, nothing else. In f32 the two sum
    the per-splat gradients in another order (that test's bounds, q99 5e-4
    and max 5e-3 of the largest entry, hold for the table's fields; the
    chain to rotations and scales amplifies the rounding); in float64 they
    agree to 1e-9."""
    fields = random_scene_arrays(400, 0.8, (0.01, 0.06), seed=6)
    _, tcam = _cams((48, 48))
    kw = dict(depth=8, tile=(16, 16), max_candidates=256, max_global=32)
    for dtype, q_lim, max_lim in ((torch.float64, 1e-9, 1e-9),
                                  (torch.float32, 5e-3, 0.2)):
        a = _port_scene_grads(fields, tcam, kw, dtype=dtype)
        b = _port_scene_grads(fields, tcam, dict(kw, tile_bands=3),
                              dtype=dtype)
        for name in GRAD_FIELDS:
            assert np.abs(a[name]).max() > 0, name
            q, worst = _q99(b[name], a[name])
            assert q <= q_lim and worst <= max_lim, (name, dtype, q, worst)
            if dtype == torch.float32 and name in ("colors", "opacities",
                                                   "sh"):
                assert q < 5e-4 and worst < 5e-3, (name, q, worst)


def test_banded_backward_runs_the_keys_stage_again(monkeypatch):
    """Per-band recomputation: a banded forward+backward runs the keys
    stage 2 × bands times, an unbanded one and any forward without
    gradients once per band."""
    calls = []
    real = ttiled.peel_keys
    monkeypatch.setattr(ttiled, "peel_keys",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    fields = random_scene_arrays(300, 0.8, (0.02, 0.1), seed=2)
    _, tcam = _cams((48, 48))
    kw = dict(depth=8, tile=(16, 16), max_candidates=256, max_global=32)

    def run(grad, bands):
        calls.clear()
        g = gaussians_from_numpy(fields, device="cpu")
        if grad:
            g = dataclasses.replace(g, means=g.means.requires_grad_())
        img = ttiled.render_tiled_keys(g, tcam, tile_bands=bands, **kw)
        if grad:
            img.sum().backward()
        return len(calls)

    assert run(True, 3) == 6
    assert run(True, None) == 1
    assert run(False, 3) == 3
    with torch.no_grad():
        assert run(False, 3) == 3


# ----- training through the keys path -----

STEP_KW = dict(tile=(8, 8), max_candidates=128, max_global=16)


def test_train_step_matches_jax():
    """One whole step against the JAX make_train_step(renderer="keys"), as
    tests/test_torch_train.py::test_train_step_matches_jax holds the fused
    path: one JAX step from a fresh optax state, the state and parameters
    through the bridge, then both packages take the second step. Moments by
    quantile (q99 < 5e-3, max < 0.2 of the largest entry); parameter steps
    in units of the group's lr where the first moment is above 1% of the
    group's largest (q99 < 0.05, max < 0.1), and max < 2 everywhere."""
    from rtgs_tpu_torch.bridge import adam_state_to_numpy

    fields = random_scene_arrays(80, 0.8, (0.02, 0.1), seed=3)
    jcam, tcam = _cams((16, 16))
    with torch.no_grad():
        target = ttiled.render_tiled_keys(
            gaussians_from_numpy(fields, device="cpu"), tcam, depth=8,
            **STEP_KW).numpy()
    rng = np.random.default_rng(9)
    names = jsolver.SceneParams._fields
    p0 = {f: np.asarray(v) for f, v in zip(
        names, jsolver.init_params(_jscene(fields)))}
    p0["color_logits"] = (p0["color_logits"] + 0.5 * rng.standard_normal(
        p0["color_logits"].shape)).astype(np.float32)
    p0["means"] = (p0["means"] + 0.01 * rng.standard_normal(
        p0["means"].shape)).astype(np.float32)
    mask = np.ones(80, np.float32)

    jcfg, tcfg = JTrainConfig(), TrainConfig()
    opt_j = jsolver.make_optimizer(jcfg)
    step_j = jsolver.make_train_step(jcfg, opt_j, depth=8, renderer="keys",
                                     **STEP_KW)
    pj = jsolver.SceneParams(**{f: jnp.asarray(v) for f, v in p0.items()})
    pj, st, _ = step_j(pj, jnp.asarray(mask), opt_j.init(pj), jcam,
                       jnp.asarray(target))
    p1 = {f: np.asarray(getattr(pj, f)) for f in names}

    pt = tsolver.SceneParams(*(p.clone().requires_grad_()
                               for p in params_from_numpy(p1, device="cpu")))
    opt_t = tsolver.make_optimizer(tcfg, pt)
    adam_state_from_optax(st, opt_t, pt)
    step_t = tsolver.make_train_step(tcfg, opt_t, depth=8, renderer="keys",
                                     **STEP_KW)
    pj2, st2, mj = step_j(pj, jnp.asarray(mask), st, jcam,
                          jnp.asarray(target))
    mt = step_t(pt, torch.from_numpy(mask), tcam, torch.from_numpy(target))

    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-3)
    q, worst = _q99(mt["grad_means_norm"].numpy(),
                    np.asarray(mj["grad_means_norm"]))
    assert q < 5e-3 and worst < 0.2, (q, worst)
    lrs = dict(means=tcfg.lr_means, quats=tcfg.lr_quats,
               log_scales=tcfg.lr_scales, color_logits=tcfg.lr_colors,
               opacity_logits=tcfg.lr_opacities, sh=tcfg.lr_sh)
    got = adam_state_to_numpy(opt_t, pt)
    for f, p in zip(names, pt):
        diff = np.abs((p.detach().numpy() - p1[f]) / lrs[f]
                      - (np.asarray(getattr(pj2, f)) - p1[f]) / lrs[f])
        adam = st2.inner_states[f].inner_state[0]
        mu_j = np.abs(np.asarray(getattr(adam.mu, f)))
        big = mu_j > 0.01 * mu_j.max()
        assert big.mean() > 0.1, f
        assert np.quantile(diff[big], 0.99) < 0.05, f
        assert diff[big].max() < 0.1 and diff.max() < 2, (
            f, diff[big].max(), diff.max())
        for key in ("mu", "nu"):
            q, worst = _q99(got[f][key], np.asarray(
                getattr(getattr(adam, key), f)))
            assert q < 5e-3 and worst < 0.2, (f, key, q, worst)


def test_solver_trains_through_keys():
    """A few steps of the Solver through ``keys`` lower the loss of a
    perturbed scene against its own renders."""
    g = random_scene(150, extent=0.5, seed=3, device="cpu")
    _, tcam = _cams((24, 16), r=2.5)
    kw = dict(max_candidates=256, tile_bands=2)
    with torch.no_grad():
        target = ttiled.render_tiled_keys(g, tcam, depth=8, **kw)
    params = tsolver.init_params(g)
    gen = torch.Generator().manual_seed(0)
    params = params._replace(color_logits=params.color_logits + 0.5
                             * torch.randn(params.color_logits.shape,
                                           generator=gen))
    cfg = TrainConfig(densify_from=10**9, opacity_reset_every=0,
                      checkpoint_every=0)
    solver = tsolver.Solver(params=params, mask=g.mask, cfg=cfg,
                            cameras=[tcam], targets=[target], depth=8,
                            renderer="keys", render_kwargs=kw)
    losses = [solver.train_step()["loss"] for _ in range(8)]
    assert losses[-1] < 0.8 * losses[0], losses


# ----- the CLI -----

@pytest.fixture
def scene_path(tmp_path):
    path = tmp_path / "toy.ply"
    save_scene(path, random_scene(120, extent=0.5, seed=3, device="cpu"))
    return path


CLI_ARGS = ["-r", "24,16", "-d", "8", "--radius", "2.5", "--fov", "60",
            "--device", "cpu"]


def test_cli_fit_renderer_keys(scene_path, tmp_path, capsys):
    out = tmp_path / "keys_fit.ply"
    main(["fit", "-o", str(scene_path), *CLI_ARGS, "--views", "2", "--steps",
          "3", "--renderer", "keys", "--output", str(out)])
    line = capsys.readouterr().out
    assert "fit 3 steps: loss=" in line and out.is_file()


@pytest.mark.parametrize("renderer", ["auto", "pallas"])
def test_cli_bench(scene_path, capsys, renderer):
    main(["bench", "-o", str(scene_path), *CLI_ARGS, "--iters", "2",
          "--renderer", renderer])
    line = capsys.readouterr().out
    assert "M rays/s (" in line and "ms/frame compute" in line
    assert "with full image readback" in line and "120 splats, depth 8" in line


def test_cli_needs_cuda_unless_asked_for_the_cpu(scene_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = [a for a in CLI_ARGS if a not in ("--device", "cpu")]
    for cmd in (["bench", "--iters", "1"],
                ["fit", "--renderer", "keys", "--steps", "1"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([cmd[0], "-o", str(scene_path), *args, *cmd[1:]])


def test_cli_never_imports_jax(scene_path, tmp_path):
    """``fit --renderer keys`` and ``bench`` in a fresh interpreter where
    importing jax, rtgs_tpu or scripts fails."""
    out = tmp_path / "nojax.ply"
    fit = ["fit", "-o", str(scene_path), *CLI_ARGS, "--views", "2",
           "--steps", "2", "--renderer", "keys", "--output", str(out)]
    bench = ["bench", "-o", str(scene_path), *CLI_ARGS, "--iters", "1"]
    code = (
        "import sys\n"
        "for name in ('jax', 'rtgs_tpu', 'scripts'):\n"
        "    sys.modules[name] = None\n"
        "from rtgs_tpu_torch.__main__ import main\n"
        f"main({fit!r})\n"
        f"main({bench!r})\n"
        "assert not any(m.split('.')[0] in ('jax', 'jaxlib') and "
        "sys.modules[m] is not None for m in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "fit 2 steps" in res.stdout and "rays/s" in res.stdout
