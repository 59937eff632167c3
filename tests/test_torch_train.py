"""The port's training (rtgs_tpu_torch.train, rtgs_tpu_torch.config and the
CLI's fit) against the JAX package's rtgs_tpu.train on the same inputs,
made with numpy and passed through rtgs_tpu_torch.bridge: losses and
their gradients, activations and initializations, Adam against optax, one
whole training step through the fused-payload renderer (the JAX kernels in
interpret mode), density control, and the port's own checkpoint, reset,
dataset and CLI paths."""

import dataclasses
import json
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
from rtgs_tpu.camera import camera_from_fov, image_to_display
from rtgs_tpu.config import TrainConfig as JTrainConfig
from rtgs_tpu.train import loss as jloss
from rtgs_tpu.train import solver as jsolver
from rtgs_tpu.utils import quaternion as jquat
from rtgs_tpu.viewer.orbit import orbit_camera_pose
from rtgs_tpu_torch.__main__ import main
from rtgs_tpu_torch.bridge import (adam_state_from_optax, adam_state_to_numpy,
                                   camera_from_numpy, gaussians_from_numpy,
                                   params_from_numpy, params_to_numpy)
from rtgs_tpu_torch.config import TrainConfig
from rtgs_tpu_torch.render.tiled import render_tiled_pallas
from rtgs_tpu_torch.scene import random_scene, random_scene_arrays, save_scene
from rtgs_tpu_torch.train import loss as tloss
from rtgs_tpu_torch.train import solver as tsolver

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = jsolver.SceneParams._fields
# No densification, resets or checkpoints unless a test asks for them.
QUIET = dict(densify_from=10**9, opacity_reset_every=0, checkpoint_every=0)


def _cam(theta=0.3, res=(16, 16), r=3.0):
    pos, rot, _, _ = orbit_camera_pose(theta, 1.2, r, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    return camera_from_fov(pos, rot, res, 60.0)


def _jscene(fields):
    return JG.Gaussians(**{k: jnp.asarray(v) for k, v in fields.items()})


def _images(seed=0, shape=(24, 20, 3)):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, shape).astype(np.float32)
    tgt = np.clip(img + 0.2 * rng.standard_normal(shape), 0, 1)
    return img, tgt.astype(np.float32)


# ----- losses -----

@pytest.mark.parametrize("name", ["l1_loss", "ssim", "psnr", "render_loss"])
def test_loss_and_gradient_match_jax(name):
    img, tgt = _images()
    j_fn, t_fn = getattr(jloss, name), getattr(tloss, name)
    val_j, grad_j = jax.value_and_grad(
        lambda x: j_fn(x, jnp.asarray(tgt)))(jnp.asarray(img))
    x = torch.from_numpy(img).requires_grad_()
    val_t = t_fn(x, torch.from_numpy(tgt))
    val_t.backward()
    np.testing.assert_allclose(float(val_t), float(val_j), rtol=1e-5)
    g, gj = x.grad.numpy(), np.asarray(grad_j)
    np.testing.assert_allclose(g / np.abs(gj).max(), gj / np.abs(gj).max(),
                               atol=1e-5)


def test_loss_identities():
    img, _ = _images(1)
    x = torch.from_numpy(img)
    assert float(tloss.ssim(x, x)) > 0.999
    assert float(tloss.render_loss(x, x)) < 1e-6
    a, b = torch.zeros((8, 8, 3)), torch.full((8, 8, 3), 0.5)
    assert float(tloss.l1_loss(a, b)) == 0.5
    np.testing.assert_allclose(float(tloss.psnr(a, b)), -10 * np.log10(0.25),
                               rtol=1e-6)


# ----- parameters -----

def test_activate_and_init_params_match_jax():
    fields = random_scene_arrays(40, 0.6, (0.02, 0.1), seed=2)
    fields["opacities"][0] = 1.0                  # clipped to 1 − 1e-6
    pj = jsolver.init_params(_jscene(fields))
    pt = tsolver.init_params(gaussians_from_numpy(fields, device="cpu"))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(pt, f).numpy(),
                                   np.asarray(getattr(pj, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    mask = np.ones(40, np.float32)
    mask[3] = 0
    gj = jsolver.activate(pj, jnp.asarray(mask))
    gt = tsolver.activate(pt, torch.from_numpy(mask))
    for f in JG.Gaussians._fields:
        np.testing.assert_allclose(getattr(gt, f).numpy(),
                                   np.asarray(getattr(gj, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)


@pytest.mark.parametrize("n", [31, 50, 600])
def test_init_params_from_points_matches_jax(n):
    """Odd and even subsample sizes (the median's two cases) and more
    points than the 512-point subsample."""
    rng = np.random.default_rng(n)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    for colors in (None, cols):
        pj = jsolver.init_params_from_points(
            None, jnp.asarray(pts),
            colors=None if colors is None else jnp.asarray(colors))
        pt = tsolver.init_params_from_points(
            torch.from_numpy(pts),
            colors=None if colors is None else torch.from_numpy(colors))
        for f in FIELDS:
            np.testing.assert_allclose(getattr(pt, f).numpy(),
                                       np.asarray(getattr(pj, f)),
                                       rtol=1e-6, atol=1e-6, err_msg=f)


def _random_params(n, seed):
    rng = np.random.default_rng(seed)
    shapes = dict(means=(n, 3), quats=(n, 4), log_scales=(n, 3),
                  color_logits=(n, 3), opacity_logits=(n,),
                  sh=(n, 15, 3))
    return {f: rng.standard_normal(shapes[f]).astype(np.float32)
            for f in FIELDS}


def test_adam_steps_match_optax():
    """Three steps of per-group Adam (eps 1e-15, the TrainConfig lrs) on
    the same gradients: parameters and moments agree to f32 rounding
    (parameters to 1e-4 of the group's lr plus two f32 ulps of the
    largest parameter; moments to 1e-6 of the largest)."""
    cfg = TrainConfig()
    p0 = _random_params(20, 0)
    pj = jsolver.SceneParams(**{f: jnp.asarray(v) for f, v in p0.items()})
    opt_j = jsolver.make_optimizer(JTrainConfig())
    st = opt_j.init(pj)
    pt = tsolver.SceneParams(*(p.clone().requires_grad_()
                               for p in params_from_numpy(p0, device="cpu")))
    opt_t = tsolver.make_optimizer(cfg, pt)
    for k in range(3):
        grads = _random_params(20, 10 + k)
        grads["sh"][:2] = 0.0                   # zero gradients update too
        upd, st = opt_j.update(
            jsolver.SceneParams(**{f: jnp.asarray(v)
                                   for f, v in grads.items()}), st, pj)
        pj = jax.tree.map(lambda a, b: a + b, pj, upd)
        for f, p in zip(FIELDS, pt):
            p.grad = torch.from_numpy(grads[f])
        opt_t.step()
    got = adam_state_to_numpy(opt_t, pt)
    for (f, p), group in zip(zip(FIELDS, pt), opt_t.param_groups):
        ref = np.asarray(getattr(pj, f))
        tol = 1e-4 * group["lr"] + 2 * np.spacing(np.abs(ref).max())
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=0,
                                   atol=tol, err_msg=f)
        adam = st.inner_states[f].inner_state[0]
        assert got[f]["count"] == int(adam.count) == 3
        for key in ("mu", "nu"):
            ref = np.asarray(getattr(getattr(adam, key), f))
            scale = np.abs(ref).max()
            np.testing.assert_allclose(got[f][key] / scale, ref / scale,
                                       atol=1e-6, err_msg=f"{f} {key}")


# ----- one training step through the fused-payload renderer -----

STEP_KW = dict(tile=(8, 8), max_candidates=128, max_global=16)


def _q(got, ref):
    rel = np.abs(got - ref) / (np.abs(ref).max() + 1e-12)
    return np.quantile(rel, 0.99), rel.max()


def test_train_step_matches_jax():
    """~80 splats, 16×16, 8×8 tiles, depth 8: one JAX step from a fresh
    optax state, then the state and parameters go through the bridge and
    both packages take the second step (Adam's bias corrections at count
    2). The two gradients differ by f32 noise: the shading exponent
    B²/4A − (c0+3) cancels, so α carries ~1e-3 relative error in either
    package, and per element the gradients differ by ~0.1% (median) to a
    few % (max). Moments are compared by quantile (q99 < 5e-3, max < 0.2
    of the largest entry). Adam normalizes each element's step to ~lr, so
    parameter steps are compared in units of the group's lr: where the
    element's first moment is above 1% of the group's largest, q99 < 0.05
    and max < 0.1; everywhere, max < 2 (a noise-sized gradient may flip
    its step's sign)."""
    fields = random_scene_arrays(80, 0.8, (0.02, 0.1), seed=3)
    jcam = _cam()
    tcam = camera_from_numpy(jcam, device="cpu")
    with torch.no_grad():
        target = render_tiled_pallas(
            gaussians_from_numpy(fields, device="cpu"), tcam, depth=8,
            **STEP_KW).numpy()
    rng = np.random.default_rng(9)
    p0 = {f: np.asarray(v) for f, v in zip(
        FIELDS, jsolver.init_params(_jscene(fields)))}
    p0["color_logits"] = (p0["color_logits"] + 0.5 * rng.standard_normal(
        p0["color_logits"].shape)).astype(np.float32)
    p0["means"] = (p0["means"] + 0.01 * rng.standard_normal(
        p0["means"].shape)).astype(np.float32)
    mask = np.ones(80, np.float32)

    jcfg, tcfg = JTrainConfig(), TrainConfig()
    opt_j = jsolver.make_optimizer(jcfg)
    step_j = jsolver.make_train_step(jcfg, opt_j, depth=8,
                                     renderer="pallas", **STEP_KW)
    pj = jsolver.SceneParams(**{f: jnp.asarray(v) for f, v in p0.items()})
    pj, st, _ = step_j(pj, jnp.asarray(mask), opt_j.init(pj), jcam,
                       jnp.asarray(target))
    p1 = {f: np.asarray(getattr(pj, f)) for f in FIELDS}

    pt = tsolver.SceneParams(*(p.clone().requires_grad_()
                               for p in params_from_numpy(p1, device="cpu")))
    opt_t = tsolver.make_optimizer(tcfg, pt)
    adam_state_from_optax(st, opt_t, pt)
    step_t = tsolver.make_train_step(tcfg, opt_t, depth=8,
                                     renderer="pallas", **STEP_KW)
    pj2, st2, mj = step_j(pj, jnp.asarray(mask), st, jcam,
                          jnp.asarray(target))
    mt = step_t(pt, torch.from_numpy(mask), tcam, torch.from_numpy(target))

    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-3)
    np.testing.assert_allclose(float(mt["psnr"]), float(mj["psnr"]),
                               rtol=1e-3)
    q, worst = _q(mt["grad_means_norm"].numpy(),
                  np.asarray(mj["grad_means_norm"]))
    assert q < 5e-3 and worst < 0.2, (q, worst)
    lrs = dict(means=tcfg.lr_means, quats=tcfg.lr_quats,
               log_scales=tcfg.lr_scales, color_logits=tcfg.lr_colors,
               opacity_logits=tcfg.lr_opacities, sh=tcfg.lr_sh)
    got = adam_state_to_numpy(opt_t, pt)
    for f, p in zip(FIELDS, pt):
        step_t_f = (p.detach().numpy() - p1[f]) / lrs[f]
        step_j_f = (np.asarray(getattr(pj2, f)) - p1[f]) / lrs[f]
        diff = np.abs(step_t_f - step_j_f)
        assert np.abs(step_j_f).max() > 0.1, f
        adam = st2.inner_states[f].inner_state[0]
        mu_j = np.abs(np.asarray(getattr(adam.mu, f)))
        big = mu_j > 0.01 * mu_j.max()
        assert big.mean() > 0.1, f
        assert np.quantile(diff[big], 0.99) < 0.05, (f, np.quantile(
            diff[big], 0.99))
        assert diff[big].max() < 0.1 and diff.max() < 2, (
            f, diff[big].max(), diff.max())
        assert got[f]["count"] == int(adam.count) == 2
        for key in ("mu", "nu"):
            q, worst = _q(got[f][key], np.asarray(getattr(getattr(adam, key),
                                                          f)))
            assert q < 5e-3 and worst < 0.2, (f, key, q, worst)


# ----- density control -----

def _density_state():
    """A state that prunes (low opacity, a runaway scale, a dead slot),
    clones, splits, and must grow its capacity."""
    n = 64
    rng = np.random.default_rng(21)
    fields = random_scene_arrays(n, 0.6, (0.005, 0.08), seed=8)
    p0 = {f: np.array(v) for f, v in zip(
        FIELDS, jsolver.init_params(_jscene(fields)))}
    p0["opacity_logits"][:3] = -12.0
    p0["log_scales"][3] = np.log(100.0)
    mask = np.ones(n, np.float32)
    mask[-2:] = 0.0
    accum = rng.uniform(0, 2e-3, n).astype(np.float32)
    count = rng.integers(0, 4, n).astype(np.int32)
    grads = [_random_params(n, 30 + k) for k in range(2)]
    cfg = dict(QUIET, percent_dense=0.05)
    return p0, mask, accum, count, grads, cfg


def test_densify_and_prune_matches_jax():
    p0, mask, accum, count, grads, cfg = _density_state()
    jcam = _cam()
    blank = np.zeros((16, 16, 3), np.float32)
    js = jsolver.Solver(
        params=jsolver.SceneParams(**{f: jnp.asarray(v)
                                      for f, v in p0.items()}),
        mask=jnp.asarray(mask), cfg=JTrainConfig(**cfg), cameras=[jcam],
        targets=[blank], depth=8, renderer="oracle")
    for gr in grads:   # non-zero moments, parameters unchanged
        _, js.opt_state = js.optimizer.update(
            jsolver.SceneParams(**{f: jnp.asarray(v) for f, v in gr.items()}),
            js.opt_state, js.params)
    ts = tsolver.Solver(params=params_from_numpy(p0, device="cpu"),
                        mask=torch.from_numpy(mask), cfg=TrainConfig(**cfg),
                        cameras=[camera_from_numpy(jcam, device="cpu")],
                        targets=[blank],
                        depth=8)
    adam_state_from_optax(js.opt_state, ts.optimizer, ts.params)
    assert ts.scene_extent == js.scene_extent
    for s in (js, ts):
        s._grad_accum, s._grad_count, s.step = accum.copy(), count.copy(), 7
    js.densify_and_prune()
    ts.densify_and_prune()

    mj = np.asarray(js.mask)
    assert mj.shape == (256,)                 # capacity grew
    assert mj.sum() > mask.sum()              # clones and splits landed
    np.testing.assert_array_equal(ts.mask.numpy(), mj)
    got = params_to_numpy(ts.params)
    for f in FIELDS:
        # Split children draw their offsets from the same numpy stream;
        # only the f32 rotation matrix is computed by each framework.
        np.testing.assert_allclose(got[f], np.asarray(getattr(js.params, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    moments = adam_state_to_numpy(ts.optimizer, ts.params)
    for f in FIELDS:
        adam = js.opt_state.inner_states[f].inner_state[0]
        assert moments[f]["count"] == int(adam.count) == 2
        for key in ("mu", "nu"):
            np.testing.assert_array_equal(
                moments[f][key], np.asarray(getattr(getattr(adam, key), f)))
    assert (moments["means"]["mu"][~mj.astype(bool)] == 0).all()
    np.testing.assert_array_equal(ts._grad_accum, js._grad_accum)


def test_world_size_prune_matches_jax():
    """tests/test_train.py:282: a splat whose scale inflates past
    prune_max_scale × scene_extent is removed at the next densify step
    (the 3DGS world-size prune), by both packages on the same inputs: the
    same mask after the step, 16 → 15 live."""
    from rtgs_tpu.render.oracle import render_oracle as j_render_oracle
    from rtgs_tpu.scene import random_scene as j_random_scene

    gt = j_random_scene(jax.random.PRNGKey(42), 16, extent=0.6,
                        scale_range=(0.002, 0.005))
    jcam = _cam(0.0, res=(16, 16), r=2.5)
    target = j_render_oracle(gt, jcam, depth=8)
    params = jsolver.init_params(gt)
    params = params._replace(
        log_scales=params.log_scales.at[0].set(np.log(100.0)))
    cfg = dict(densify_from=1, densify_every=1,
               densify_grad_threshold=1e9,       # no clones or splits
               opacity_reset_every=0, checkpoint_every=0)
    js = jsolver.Solver(params=params, mask=gt.mask, cfg=JTrainConfig(**cfg),
                        cameras=[jcam], targets=[target], depth=8,
                        renderer="oracle")
    ts = tsolver.Solver(params=params_from_numpy(params, device="cpu"),
                        mask=torch.from_numpy(np.array(gt.mask)),
                        cfg=TrainConfig(**cfg),
                        cameras=[camera_from_numpy(jcam, device="cpu")],
                        targets=[np.array(target)], depth=8,
                        renderer="oracle")
    assert ts.num_live == js.num_live == 16
    js.train_step()
    ts.train_step()
    assert ts.num_live == js.num_live == 15
    assert float(ts.mask[0]) == 0.0
    np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(js.mask))


def test_split_rotation_matches_jax():
    """The one framework-computed piece of a split: the f32 rotation."""
    q = np.random.default_rng(4).standard_normal((16, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    from rtgs_tpu_torch.utils import quaternion as tquat

    np.testing.assert_allclose(
        tquat.as_rotation_mat3(torch.from_numpy(q)).numpy(),
        np.asarray(jquat.as_rotation_mat3(jnp.asarray(q))), atol=1e-6)


# ----- the port's own solver paths -----

@pytest.fixture
def toy_solver():
    g = random_scene(24, extent=0.5, seed=5, device="cpu")
    cams = [camera_from_numpy(_cam(t, res=(16, 16), r=2.5), device="cpu")
            for t in (0.0, 2.1)]
    with torch.no_grad():
        targets = [render_tiled_pallas(g, c, depth=8, **STEP_KW)
                   for c in cams]
    params = tsolver.init_params(g)
    params = params._replace(color_logits=params.color_logits + 1.0)
    return tsolver.Solver(params=params, mask=g.mask,
                          cfg=TrainConfig(lr_colors=5e-2, **QUIET),
                          cameras=cams, targets=targets, depth=8,
                          render_kwargs=STEP_KW)


def test_fit_recovers_scene(toy_solver):
    first = toy_solver.train_step()
    for _ in range(25):
        last = toy_solver.train_step()
    assert last["loss"] < 0.7 * first["loss"]
    assert last["psnr"] > first["psnr"] + 2


def test_reset_opacity_keeps_other_moments(toy_solver):
    toy_solver.train_step()
    toy_solver.train_step()
    before = adam_state_to_numpy(toy_solver.optimizer, toy_solver.params)
    toy_solver.reset_opacity()
    after = adam_state_to_numpy(toy_solver.optimizer, toy_solver.params)
    for f in FIELDS:
        if f == "opacity_logits":
            assert after[f]["count"] == 0 and not after[f]["mu"].any()
        else:
            assert after[f]["count"] == before[f]["count"] == 2
            np.testing.assert_array_equal(after[f]["mu"], before[f]["mu"])
    assert float(toy_solver.params.opacity_logits.max()) <= np.log(0.01 / 0.99)
    assert np.isfinite(toy_solver.train_step()["loss"])


def test_checkpoint_roundtrip_restores_optimizer(toy_solver, tmp_path):
    toy_solver.train_step()
    toy_solver.save_checkpoint(tmp_path)
    saved = params_to_numpy(toy_solver.params)
    moments = adam_state_to_numpy(toy_solver.optimizer, toy_solver.params)
    toy_solver.train_step()
    assert not np.array_equal(params_to_numpy(toy_solver.params)["means"],
                              saved["means"])
    toy_solver.restore_checkpoint(tmp_path, 1)
    assert toy_solver.step == 1
    for f, v in params_to_numpy(toy_solver.params).items():
        np.testing.assert_array_equal(v, saved[f])
    restored = adam_state_to_numpy(toy_solver.optimizer, toy_solver.params)
    for f in FIELDS:
        assert restored[f]["count"] == moments[f]["count"] == 1
        np.testing.assert_array_equal(restored[f]["mu"], moments[f]["mu"])
        np.testing.assert_array_equal(restored[f]["nu"], moments[f]["nu"])
    # Training goes on from the restored state, with the restored tensors.
    assert np.isfinite(toy_solver.train_step()["loss"])
    assert toy_solver.optimizer.param_groups[0]["params"][0] is \
        toy_solver.params.means


def test_densify_every_zero_steps_past_densify_from(toy_solver):
    """``densify_every = 0`` turns the density pass off, as
    ``opacity_reset_every = 0`` turns the reset off: steps past
    ``densify_from`` inside ``densify_until`` run and change no capacity
    (it divided by zero at step ``densify_from``)."""
    toy_solver.cfg = dataclasses.replace(toy_solver.cfg, densify_from=1,
                                         densify_until=10, densify_every=0)
    for _ in range(3):
        assert np.isfinite(toy_solver.train_step()["loss"])
    assert toy_solver.step == 3 and toy_solver.num_live == 24
    assert toy_solver.mask.shape == (24,)


def test_grow_keeps_moments(toy_solver):
    toy_solver.train_step()
    before = adam_state_to_numpy(toy_solver.optimizer, toy_solver.params)
    toy_solver._grow(10)
    after = adam_state_to_numpy(toy_solver.optimizer, toy_solver.params)
    assert toy_solver.mask.shape == (256,) and toy_solver.num_live == 24
    for f in FIELDS:
        np.testing.assert_array_equal(after[f]["mu"][:24], before[f]["mu"])
        assert not after[f]["mu"][24:].any()
    assert np.isfinite(toy_solver.train_step()["loss"])


def test_load_transforms_dataset_matches_jax(tmp_path):
    from rtgs_tpu.train.datasets import load_transforms_dataset as j_load
    from rtgs_tpu.utils.image import save_image
    from rtgs_tpu_torch.train.datasets import load_transforms_dataset

    rng = np.random.default_rng(2)
    frames = []
    for i, theta in enumerate([0.0, 2.1]):
        cam = _cam(theta, res=(20, 16))
        save_image(tmp_path / f"r_{i}.png", np.asarray(image_to_display(
            jnp.asarray(rng.uniform(0, 1, (20, 16, 3)).astype(np.float32)))))
        m = np.eye(4)
        m[:3, :3] = np.asarray(jquat.as_rotation_mat3(cam.rotation))
        m[:3, 3] = np.asarray(cam.position)
        frames.append({"file_path": f"r_{i}", "transform_matrix": m.tolist()})
    (tmp_path / "transforms.json").write_text(json.dumps({
        "camera_angle_x": 0.9, "frames": frames}))
    dj = j_load(tmp_path / "transforms.json", downscale=2)
    dt = load_transforms_dataset(tmp_path / "transforms.json", downscale=2,
                                 device="cpu")
    assert len(dt) == len(dj) == 2
    for cj, ct, ij, it in zip(dj.cameras, dt.cameras, dj.images, dt.images):
        np.testing.assert_array_equal(it, ij)
        assert ct.buf_size == tuple(cj.buf_size) == (10, 8)
        for f in ("position", "rotation", "focal_length"):
            np.testing.assert_allclose(getattr(ct, f).numpy(),
                                       np.asarray(getattr(cj, f)), atol=1e-6)


# ----- the CLI -----

@pytest.fixture
def scene_path(tmp_path):
    path = tmp_path / "toy.ply"
    save_scene(path, random_scene(120, extent=0.5, seed=3, device="cpu"))
    return path


FIT_ARGS = ["-r", "24,16", "-d", "8", "--radius", "2.5", "--fov", "60",
            "--views", "2", "--steps", "3", "--device", "cpu"]


def test_cli_fit_writes_ply(scene_path, tmp_path, capsys):
    from rtgs_tpu_torch.scene import load_scene

    out = tmp_path / "fit.ply"
    ckpt = tmp_path / "ckpt"
    main(["fit", "-o", str(scene_path), *FIT_ARGS, "--from-scratch",
          "--init-points", "50", "--tile-bands", "2", "--max-candidates",
          "256", "--checkpoint-dir", str(ckpt), "--checkpoint-every", "2",
          "--output", str(out)])
    line = capsys.readouterr().out
    assert "fit 3 steps: loss=" in line and f"live=50 -> {out}" in line
    assert load_scene(out, device="cpu").num == 50
    assert (ckpt / "step_2.pt").is_file()


@pytest.mark.parametrize("renderer", ["keys"])
def test_cli_fit_refuses_untrainable_renderers(scene_path, tmp_path,
                                               renderer, capsys):
    """No renderer is left to refuse: the last one, ``keys``, trains (in
    two bands, so through the per-band recomputation), and an unknown name
    still raises."""
    from rtgs_tpu_torch.scene import load_scene

    out = tmp_path / "x.ply"
    main(["fit", "-o", str(scene_path), *FIT_ARGS, "--renderer", renderer,
          "--tile-bands", "2", "--output", str(out)])
    line = capsys.readouterr().out
    assert "fit 3 steps: loss=" in line and f"-> {out}" in line
    assert load_scene(out, device="cpu").num == 120
    assert tsolver.training_renderer(renderer, 120, "cpu") == renderer
    with pytest.raises(ValueError, match="unknown renderer"):
        tsolver.training_renderer("nope", 120, "cpu")


def test_fit_never_imports_jax(scene_path, tmp_path):
    """Fit through the CLI in a fresh interpreter where importing jax or
    rtgs_tpu fails."""
    out = tmp_path / "nojax.ply"
    argv = ["fit", "-o", str(scene_path), *FIT_ARGS, "--output", str(out)]
    code = (
        "import sys\n"
        "for m in list(sys.modules):\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'rtgs_tpu'):\n"
        "        del sys.modules[m]\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['rtgs_tpu'] = None\n"
        "import rtgs_tpu_torch.train, rtgs_tpu_torch.config\n"
        "from rtgs_tpu_torch.__main__ import main\n"
        f"main({argv!r})\n"
        "assert not any(m.split('.')[0] in ('jax', 'jaxlib') and "
        "sys.modules[m] is not None for m in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "fit 3 steps" in res.stdout and out.is_file()
