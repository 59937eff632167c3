"""The renderer dispatch (rtgs_tpu_torch.render.api.resolve_renderer)
against the JAX package's (rtgs_tpu/render/api.py:26-31): ``auto`` is the
oracle at 4096 splats or fewer, else ``pallas`` on a CUDA scene and
``tiled`` on the CPU. Held for ``render``, ``render_progressive``,
``ProgressiveSampler``, the CLI and ``training_renderer``; the port's
``render(renderer="auto")`` against the JAX one on the CPU, at 4096
splats (oracle on both sides), above it (tiled on both sides) and on a
scene with a tie in t1 at the last layer, which the keys path breaks by
splat id and the tiled renderers by candidate slot.

Tolerances: images with tests/_utils.assert_images_close (the port's t1 is
a float64 chain and the JAX package's an f32 one, so grazing pixels may
flip); one training step as tests/test_torch_render_tiled.py holds the
oracle's (loss and PSNR to 1e-4 relative, the positional gradient norms by
quantile, q99 < 5e-3 and max < 0.2 of the largest)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtgs_tpu import gaussians as JG
from rtgs_tpu.camera import camera_from_fov
from rtgs_tpu.config import TrainConfig as JTrainConfig
from rtgs_tpu.render.api import render as j_render
from rtgs_tpu.train import solver as jsolver
from rtgs_tpu.viewer.orbit import orbit_camera_pose
from rtgs_tpu_torch.__main__ import main
from rtgs_tpu_torch.bridge import (camera_from_numpy, gaussians_from_numpy,
                                   params_from_numpy)
from rtgs_tpu_torch.camera import image_to_display
from rtgs_tpu_torch.config import TrainConfig
from rtgs_tpu_torch.ops.peel import peel_fused
from rtgs_tpu_torch.render.api import (_ORACLE_MAX_N, RENDERERS,
                                       ProgressiveSampler, render,
                                       render_progressive, resolve_renderer)
from rtgs_tpu_torch.render.oracle import render_oracle
from rtgs_tpu_torch.render.tiled import render_tiled, render_tiled_keys
from rtgs_tpu_torch.scene import random_scene_arrays, save_scene
from rtgs_tpu_torch.train import solver as tsolver
from rtgs_tpu_torch.utils.image import load_image, to_uint8
from tests._utils import assert_images_close
from tests.test_torch_train import FIELDS, _q

KW = dict(depth=8, max_candidates=512, max_global=64)
DEVICES = ("cpu", "cuda")


def _expected(renderer, num, device):
    """What the JAX rule renders for ``renderer`` at ``num`` splats on a
    device of type ``device``."""
    if renderer != "auto":
        return renderer
    if num <= 4096:
        return "oracle"
    return "pallas" if device == "cuda" else "tiled"


def test_oracle_threshold_is_the_jax_one():
    from rtgs_tpu.render import api as japi

    assert _ORACLE_MAX_N == japi._ORACLE_MAX_N == 4096


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("num", [4096, 4097])
@pytest.mark.parametrize("renderer", ["auto", *RENDERERS])
def test_resolver_table(renderer, num, device):
    """The pure resolver decides from the device it is given: a stand-in
    ``torch.device("cuda")`` needs no card."""
    got = resolve_renderer(renderer, num, torch.device(device))
    assert got == _expected(renderer, num, device)
    assert resolve_renderer(renderer, num, device) == got


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("num", [4096, 4097])
@pytest.mark.parametrize("renderer", ["auto", *RENDERERS])
def test_training_renderer_resolves_as_render(renderer, num, device):
    assert (tsolver.training_renderer(renderer, num, torch.device(device))
            == resolve_renderer(renderer, num, device))


@pytest.mark.parametrize("fn", [resolve_renderer, tsolver.training_renderer])
def test_unknown_renderer_raises(fn):
    with pytest.raises(ValueError, match="unknown renderer"):
        fn("bvh", 10, "cpu")


def test_cpu_scene_never_asks_for_a_card(monkeypatch):
    """``auto`` reads the scene's device, not ``torch.cuda.is_available``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_renderer("auto", 4097, "cpu") == "tiled"
    g = gaussians_from_numpy(random_scene_arrays(4097, 1.0, seed=2),
                             device="cpu")
    cam = _camera((24, 16))[1]
    assert torch.equal(render(g, cam, **KW), render_tiled(g, cam, **KW))


def _camera(res, pos=None):
    if pos is None:
        pos, rot, _, _ = orbit_camera_pose(0.3, 1.2, 3.0, np.zeros(3),
                                           np.array([0.0, 0.0, 0.0, 1.0]))
    else:
        rot = np.array([0.0, 0.0, 0.0, 1.0])
    jcam = camera_from_fov(pos, rot, res, 60.0)
    return jcam, camera_from_numpy(jcam, device="cpu")


def _scenes(fields):
    return (JG.Gaussians(**{k: jnp.asarray(v) for k, v in fields.items()}),
            gaussians_from_numpy(fields, device="cpu"))


def tie_scene(n=4097):
    """A scene whose middle pixel has a tie in t1 at layer 2 of 2.

    Camera at (0, 0, 5) looking down −z on an odd frame (33×33), so the
    middle pixel's ray is exactly (0, 0, −1). Splat 0, a red sphere of
    scale 0.25, and splat 1, a blue disc of scales (1, 1, 0.25), both at the
    origin and axis-aligned: along that ray only Σ⁻¹'s zz entry (16 for
    both, exact) meets the ray, so their t1 are equal bit for bit in either
    package. Splat 2, grey and half opaque, lies in front of them (layer 1).
    The disc's larger extent gives it the nearer depth bound, hence the
    lower candidate slot. The other splats lie 60 units aside, outside the
    view. So at depth 2 the keys path (lower id) shows the sphere in the
    middle pixel, and ``tiled`` and ``pallas`` (lower slot) the disc."""
    f = random_scene_arrays(n, 1.0, (0.02, 0.1), seed=5)
    f["means"][:, 0] += 60.0
    f["means"][:3] = [[0, 0, 0], [0, 0, 0], [0, 0, 2.0]]
    f["quats"][:3] = [0, 0, 0, 1]
    f["scales"][:3] = [[0.25, 0.25, 0.25], [1.0, 1.0, 0.25],
                       [0.2, 0.2, 0.2]]
    f["colors"][:3] = [[0.95, 0.05, 0.05], [0.05, 0.05, 0.95],
                       [0.5, 0.5, 0.5]]
    f["opacities"][:3] = [0.95, 0.95, 0.5]
    f["sh"][:3] = 0.0
    return f, _camera((33, 33), pos=np.array([0.0, 0.0, 5.0]))


@pytest.mark.parametrize("n", [4096, 4097, 5000])
def test_render_auto_matches_jax_auto(n):
    """The same seeded scene through the JAX ``render(auto)`` (on the CPU:
    the oracle at 4096, ``render_tiled`` above) and the port's."""
    jg, tg = _scenes(random_scene_arrays(n, 1.0, (0.02, 0.1), seed=n))
    jcam, tcam = _camera((32, 24))
    img_j = np.asarray(j_render(jg, jcam, renderer="auto", **KW))
    img_t = render(tg, tcam, renderer="auto", **KW)
    path = render_oracle if n <= 4096 else render_tiled
    ref = path(tg, tcam, **(dict(depth=KW["depth"]) if n <= 4096 else KW))
    assert torch.equal(img_t, ref)
    assert torch.isfinite(img_t).all() and img_t.abs().max() > 0.1
    assert_images_close(img_t.numpy(), img_j)


def test_render_auto_matches_jax_auto_on_a_t1_tie():
    """Above 4096 splats the port's ``auto`` breaks the tie as the JAX
    ``auto`` does (by slot); the keys path, the old ``auto``, does not."""
    f, (jcam, tcam) = tie_scene()
    jg, tg = _scenes(f)
    kw = dict(depth=2, max_candidates=64)
    img_j = np.asarray(j_render(jg, jcam, renderer="auto", **kw))
    img_t = render(tg, tcam, renderer="auto", **kw)
    assert_images_close(img_t.numpy(), img_j)
    keys = render_tiled_keys(tg, tcam, **kw).numpy()
    mid = np.abs(keys - img_j)[16, 16]
    assert mid.max() > 0.12, mid   # the keys path's layer 2 is the sphere
    assert np.abs(keys - img_j).max() == mid.max()


@pytest.mark.parametrize("n", [200, 4097])
def test_progressive_auto_resolves_as_render(n):
    """``render_progressive`` and ``ProgressiveSampler`` with ``auto``
    render what they render with the name ``render`` resolves to."""
    _, tg = _scenes(random_scene_arrays(n, 1.0, (0.02, 0.1), seed=3))
    _, tcam = _camera((24, 16))
    name = resolve_renderer("auto", n, tg.device)
    assert name == ("oracle" if n <= 4096 else "tiled")

    def gen():
        return torch.Generator().manual_seed(4)

    for jitter in (False, True):
        a = render_progressive(tg, tcam, samples=2, jitter=jitter,
                               generator=gen(), **KW)
        b = render_progressive(tg, tcam, samples=2, renderer=name,
                               jitter=jitter, generator=gen(), **KW)
        assert torch.equal(a, b)
    s_auto = ProgressiveSampler(tg, tcam, jitter=True, generator=gen(), **KW)
    s_name = ProgressiveSampler(tg, tcam, renderer=name, jitter=True,
                                generator=gen(), **KW)
    for s in (s_auto, s_name):
        s.sample().sample()
    assert torch.equal(s_auto.display(), s_name.display())
    assert torch.equal(s_auto.display(), a)


def test_cli_render_default_is_tiled_on_the_cpu(tmp_path, capsys):
    """``render`` with no ``--renderer`` of a 4097-splat scene on the CPU
    writes the ``render_tiled`` frame."""
    fields = random_scene_arrays(4097, 1.0, (0.02, 0.1), seed=6)
    ply = tmp_path / "s.ply"
    save_scene(ply, gaussians_from_numpy(fields, device="cpu"))
    out = tmp_path / "frame.png"
    main(["render", "-o", str(ply), "-r", "24,16", "-d", "8", "--radius",
          "3.0", "--device", "cpu", "--max-candidates", "512", "--output",
          str(out)])
    assert "Rendered 24x16 (4097 splats, depth 8)" in capsys.readouterr().out
    from rtgs_tpu_torch.scene import load_scene
    from rtgs_tpu_torch.__main__ import _camera as cli_camera
    import argparse

    g = load_scene(ply, device="cpu")
    args = argparse.Namespace(res=(24, 16), fov=90.0, radius=3.0, phi=None)
    with torch.inference_mode():
        ref = render_tiled(g, cli_camera(args, 0.0, "cpu"), depth=8,
                           max_candidates=512)
    want = to_uint8(image_to_display(ref).numpy())
    got = load_image(out if out.exists() else out.with_suffix(".npy"))
    np.testing.assert_array_equal(np.round(got * 255).astype(np.uint8), want)


def test_train_step_auto_matches_jax_auto():
    """One ``make_train_step(renderer="auto")`` step at 48 splats (the
    oracle on both sides) against the JAX step with ``renderer="auto"``,
    from the same parameters and fresh optimizers; and bitwise the port's
    step with ``renderer="oracle"``."""
    fields = random_scene_arrays(48, 0.8, (0.02, 0.1), seed=3)
    jcam, tcam = _camera((16, 16))
    with torch.no_grad():
        target = render_oracle(gaussians_from_numpy(fields, device="cpu"),
                               tcam, depth=8).numpy()
    rng = np.random.default_rng(9)
    p0 = {f: np.asarray(v) for f, v in zip(FIELDS, jsolver.init_params(
        JG.Gaussians(**{k: jnp.asarray(v) for k, v in fields.items()})))}
    p0["color_logits"] = (p0["color_logits"] + 0.5 * rng.standard_normal(
        p0["color_logits"].shape)).astype(np.float32)
    mask = np.ones(48, np.float32)

    opt_j = jsolver.make_optimizer(JTrainConfig())
    step_j = jsolver.make_train_step(JTrainConfig(), opt_j, depth=8,
                                     renderer="auto")
    pj = jsolver.SceneParams(**{f: jnp.asarray(v) for f, v in p0.items()})
    _, _, mj = step_j(pj, jnp.asarray(mask), opt_j.init(pj), jcam,
                      jnp.asarray(target))

    def port_step(renderer):
        pt = tsolver.SceneParams(*(
            p.clone().requires_grad_()
            for p in params_from_numpy(p0, device="cpu")))
        opt = tsolver.make_optimizer(TrainConfig(), pt)
        step = tsolver.make_train_step(TrainConfig(), opt, depth=8,
                                       renderer=renderer, max_candidates=256)
        m = step(pt, torch.from_numpy(mask), tcam, torch.from_numpy(target))
        return m, pt

    mt, pt = port_step("auto")
    mo, po = port_step("oracle")
    assert torch.equal(mt["grad_means_norm"], mo["grad_means_norm"])
    for a, b in zip(pt, po):
        assert torch.equal(a, b)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(mt["psnr"]), float(mj["psnr"]),
                               rtol=1e-4)
    q, worst = _q(mt["grad_means_norm"].numpy(),
                  np.asarray(mj["grad_means_norm"]))
    assert q < 5e-3 and worst < 0.2, (q, worst)


def test_fused_peel_keeps_no_graph_under_inference_mode():
    """The CLI and the viewer render under ``torch.inference_mode()``:
    ``PeelFused`` then builds no autograd node, so nothing holds its saved
    inputs and slots past the call."""
    from tests.test_torch_peel_fused import _inputs

    packed, cand, pix = (torch.from_numpy(np.array(x)) for x in _inputs(
        80, (16, 16), (8, 8), 128, 1, seed=7, dup=16))
    packed.requires_grad_()
    with torch.inference_mode():
        rad, trans = peel_fused(packed, cand, pix, 8)
    assert rad.grad_fn is None and trans.grad_fn is None
    rad_g, _ = peel_fused(packed, cand, pix, 8)
    assert rad_g.grad_fn is not None and torch.equal(rad_g.detach(), rad)

