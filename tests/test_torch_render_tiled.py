"""The port's per-tile argmin renderer (rtgs_tpu_torch.render.tiled.
render_tiled) against the JAX package's render_tiled, image and scene
gradients; all three port tile-or-brute-force renderers (oracle, tiled,
pallas) against the float64 goldens of tests/golden/; the renderer choices
of render and fit through the CLI; one training step through the oracle
against the JAX make_train_step; a CLI render through the oracle with
JAX made unimportable; and the port's three tile renderers (keys, pallas,
tiled) against the JAX oracle and the same JAX renderer on the cases of
tests/test_tiled.py:69 (a camera inside the cloud: the global list) and
:82 (37×23 with 16×8 tiles).

Tolerances: images with tests/_utils.assert_images_close (the port's t1 is
a float64 chain and the JAX package's an f32 one, so grazing pixels may
flip; and α's exponent B²/4A − (c0+3) cancels, so the f32 α of two
summation orders differ by ~4e-4 relative, 5e-3 at most). The port's tiled
and pallas renderers select the same winners and sum α's exponent in the
same order: their images agree to 1e-5. The goldens with
tests/test_parity_golden.py's thresholds. Scene gradients: on the scene of
that test the JAX package's own tiled and pallas renderers differ by up to
1.9e-3 of the largest entry at the 0.99 quantile (2.5e-3 at most), and the
port's tiled differs from the JAX tiled by up to 3.5e-3 (1.9e-2 at most),
all f32 noise of α; so the bound is q99 < 5e-3 and max < 0.05 of the
largest entry."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtgs_tpu.camera import camera_from_fov as j_camera_from_fov
from rtgs_tpu.config import TrainConfig as JTrainConfig
from rtgs_tpu.render.oracle import render_oracle as j_render_oracle
from rtgs_tpu.render.tiled import render_tiled as j_render_tiled
from rtgs_tpu.render.tiled import render_tiled_keys as j_render_tiled_keys
from rtgs_tpu.render.tiled import render_tiled_pallas as j_render_pallas
from rtgs_tpu.scene import random_scene as j_random_scene
from rtgs_tpu.train import solver as jsolver
from rtgs_tpu.viewer.orbit import orbit_camera_pose
from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.__main__ import main
from rtgs_tpu_torch.bridge import (adam_state_from_optax, adam_state_to_numpy,
                                   camera_from_numpy, gaussians_from_numpy,
                                   params_from_numpy)
from rtgs_tpu_torch.config import TrainConfig
from rtgs_tpu_torch.render.api import render
from rtgs_tpu_torch.render.oracle import render_oracle
from rtgs_tpu_torch.render.tiled import (render_tiled, render_tiled_keys,
                                         render_tiled_pallas)
from rtgs_tpu_torch.scene import (load_scene, random_scene,
                                  random_scene_arrays, save_scene)
from rtgs_tpu_torch.train import solver as tsolver
from tests._utils import assert_images_close
from tests.test_torch_oracle import (GOLDEN, GOLDEN_CASES, _golden_camera,
                                     assert_golden_close)
from tests.test_torch_render import _scene_and_camera
from tests.test_torch_train import FIELDS, _cam, _jscene, _q

ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(depth=16, tile=(16, 16), max_candidates=640, max_global=64)


def test_render_tiled_matches_jax_and_pallas():
    jg, jcam, tg, tcam = _scene_and_camera()
    img_j = np.asarray(j_render_tiled(jg, jcam, **KW))
    img = render_tiled(tg, tcam, **KW)
    assert img.shape == (64, 48, 3) and img.dtype == torch.float32
    assert torch.isfinite(img).all() and img.abs().max() > 0.1
    assert_images_close(img.numpy(), img_j)
    # The same winners and α as the fused-payload path.
    assert (img - render_tiled_pallas(tg, tcam, **KW)).abs().max() <= 1e-5
    # Chunking the tile axis changes nothing but the batch shapes.
    chunked = render_tiled(tg, tcam, tile_chunk=5, **KW)
    assert (chunked - img).abs().max() <= 1e-6


# The port's tile renderers and their JAX counterparts.
TILE_PATHS = {"keys": (render_tiled_keys, j_render_tiled_keys),
              "pallas": (render_tiled_pallas, j_render_pallas),
              "tiled": (render_tiled, j_render_tiled)}


def _against_jax(renderer, jg, jcam, depth, **kw):
    """The port's ``renderer`` on the JAX scene and camera, held against
    the JAX oracle and the same JAX renderer; returns the port's image."""
    port, ref = TILE_PATHS[renderer]
    img = port(gaussians_from_numpy(jg, device="cpu"),
               camera_from_numpy(jcam, device="cpu"), depth=depth,
               **kw).numpy()
    assert np.isfinite(img).all() and np.abs(img).max() > 0.05
    assert_images_close(img, np.asarray(j_render_oracle(jg, jcam,
                                                        depth=depth)))
    assert_images_close(img, np.asarray(ref(jg, jcam, depth=depth, **kw)))
    return img


@pytest.mark.parametrize("renderer", sorted(TILE_PATHS))
def test_camera_inside_scene_matches_jax(renderer):
    """tests/test_tiled.py:69: the camera inside the cloud, where many
    splats straddle or lie behind the camera plane: the binning's global
    list carries them (max_global 200 of 200 splats)."""
    jg = j_random_scene(jax.random.PRNGKey(42), 200, extent=1.0)
    jcam = j_camera_from_fov([0.1, 0.0, 0.1], [0, 0, 0, 1], (32, 24), 70.0)
    _against_jax(renderer, jg, jcam, 16, tile=(16, 8), max_candidates=256,
                 max_global=200)


@pytest.mark.parametrize("renderer", sorted(TILE_PATHS))
def test_odd_resolution_matches_jax(renderer):
    """tests/test_tiled.py:82: 37×23 with 16×8 tiles, padded to whole
    tiles and cropped back."""
    jg = j_random_scene(jax.random.PRNGKey(42), 100, extent=0.8)
    pos, rot, _, _ = orbit_camera_pose(0.3, 1.2, 3.0, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    jcam = j_camera_from_fov(pos, rot, (37, 23), 60.0)
    img = _against_jax(renderer, jg, jcam, 8, tile=(16, 8),
                       max_candidates=128, max_global=64)
    assert img.shape == (37, 23, 3)


def _scene_grads(fn, fields, cam):
    params = {f: torch.from_numpy(v.copy()).requires_grad_()
              for f, v in fields.items() if f != "mask"}
    g = G.Gaussians(mask=torch.from_numpy(fields["mask"]), **params)
    (fn(g, cam) ** 2).sum().backward()
    return {f: p.grad.numpy() for f, p in params.items()}


def test_render_tiled_scene_gradients_match_jax():
    """Gradients of Σ image² in every scene field, through binning,
    features, the argmin peel (checkpointed per tile chunk) and the
    composite, against jax.grad of the JAX render_tiled."""
    fields = random_scene_arrays(60, 0.8, (0.02, 0.1), seed=12)
    jg = _jscene(fields)
    jcam = _cam(res=(16, 16))
    kw = dict(depth=8, tile=(8, 8), max_candidates=128, max_global=16)
    grads_j = jax.grad(lambda g: jnp.sum(j_render_tiled(
        g, jcam, **kw) ** 2))(jg)
    got = _scene_grads(lambda g, c: render_tiled(g, c, tile_chunk=1, **kw),
                       fields, camera_from_numpy(jcam, device="cpu"))
    whole = _scene_grads(lambda g, c: render_tiled(g, c, **kw), fields,
                         camera_from_numpy(jcam, device="cpu"))
    for name, a in got.items():
        b = np.asarray(getattr(grads_j, name))
        assert np.isfinite(a).all(), name
        scale = np.abs(b).max() + 1e-8
        rel = np.abs(a - b) / scale
        assert np.quantile(rel, 0.99) < 5e-3, (name, np.quantile(rel, 0.99))
        assert rel.max() < 0.05, (name, rel.max())
        np.testing.assert_allclose(a, whole[name], rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=name)


RENDERERS = {
    "oracle": lambda g, cam, d: render_oracle(g, cam, depth=d),
    "tiled": lambda g, cam, d: render_tiled(
        g, cam, depth=d, max_candidates=256, max_global=64),
    "pallas": lambda g, cam, d: render_tiled_pallas(
        g, cam, depth=d, max_candidates=256, max_global=64),
}


@pytest.mark.parametrize("npz,ply", GOLDEN_CASES)
@pytest.mark.parametrize("renderer", list(RENDERERS))
def test_image_parity_with_golden(npz, ply, renderer):
    z = np.load(GOLDEN / npz)
    scale = float(z["scale"]) if "scale" in z else 1.0
    g = load_scene(GOLDEN / ply, scale=scale, sh_layout="reference_flat",
                   device="cpu")
    with torch.no_grad():
        img = RENDERERS[renderer](g, _golden_camera(z), int(z["depth"]))
    assert_golden_close(img, z["img"], f"{npz}/{renderer}")


def test_render_dispatch_drops_knobs():
    """render(renderer=oracle|tiled|auto) matches the functions, with the
    tiled-only knobs dropped for the oracle and tile_bands for tiled."""
    _, _, tg, tcam = _scene_and_camera(n=200, res=(32, 32))
    knobs = dict(max_candidates=640, max_global=64, tile_bands=2,
                 bin_narrow=4, tile=(16, 16))
    assert torch.equal(render(tg, tcam, renderer="oracle", **knobs),
                       render_oracle(tg, tcam))
    kw = {k: v for k, v in knobs.items() if k != "tile_bands"}
    assert torch.equal(render(tg, tcam, renderer="tiled", **knobs),
                       render_tiled(tg, tcam, **kw))
    # auto is the JAX rule: the oracle at 4096 splats or fewer, so the
    # knobs are dropped as for the oracle.
    assert torch.equal(render(tg, tcam, renderer="auto", **knobs),
                       render_oracle(tg, tcam))
    with pytest.raises(ValueError, match="unknown renderer"):
        render(tg, tcam, renderer="bvh")


@pytest.fixture
def scene_path(tmp_path):
    path = tmp_path / "toy.ply"
    save_scene(path, random_scene(64, extent=0.4, seed=3, device="cpu"))
    return path


@pytest.mark.parametrize("renderer", ["oracle", "tiled"])
def test_cli_render(scene_path, tmp_path, capsys, renderer):
    out = tmp_path / "frame.png"
    main(["render", "-o", str(scene_path), "-r", "32,24", "-d", "8",
          "--radius", "2.0", "--device", "cpu", "--renderer", renderer,
          "--max-candidates", "256", "--tile-bands", "2",
          "--output", str(out)])
    assert out.exists() or out.with_suffix(".npy").exists()
    assert "Rendered 32x24 (64 splats, depth 8)" in capsys.readouterr().out


@pytest.mark.parametrize("renderer", ["oracle", "tiled"])
def test_cli_fit(scene_path, tmp_path, capsys, renderer):
    out = tmp_path / "fit.ply"
    main(["fit", "-o", str(scene_path), "-r", "24,16", "-d", "8",
          "--radius", "2.5", "--fov", "60", "--views", "2", "--steps", "3",
          "--device", "cpu", "--renderer", renderer, "--from-scratch",
          "--init-points", "40", "--output", str(out)])
    line = capsys.readouterr().out
    assert "fit 3 steps: loss=" in line and f"live=40 -> {out}" in line
    assert load_scene(out, device="cpu").num == 40


def test_train_step_through_oracle_matches_jax():
    """One JAX step through the oracle from a fresh optax state, then the
    state and parameters go through the bridge and both packages take the
    second step (Adam's bias corrections at count 2), as
    tests/test_torch_train.py:test_train_step_matches_jax does through the
    fused path, with its tolerances: the same f32 arithmetic in another
    summation order, so moments agree by quantile (q99 < 5e-3, max < 0.2
    of the largest) and steps in units of the group's lr (where the first
    moment is above 1% of the group's largest, q99 < 0.05 and max < 0.1;
    everywhere max < 2, a noise-sized gradient may flip its step)."""
    fields = random_scene_arrays(48, 0.8, (0.02, 0.1), seed=3)
    jcam = _cam()
    tcam = camera_from_numpy(jcam, device="cpu")
    with torch.no_grad():
        target = render_oracle(gaussians_from_numpy(fields, device="cpu"),
                               tcam, depth=8).numpy()
    rng = np.random.default_rng(9)
    p0 = {f: np.asarray(v) for f, v in zip(
        FIELDS, jsolver.init_params(_jscene(fields)))}
    p0["color_logits"] = (p0["color_logits"] + 0.5 * rng.standard_normal(
        p0["color_logits"].shape)).astype(np.float32)
    p0["means"] = (p0["means"] + 0.01 * rng.standard_normal(
        p0["means"].shape)).astype(np.float32)
    mask = np.ones(48, np.float32)

    jcfg, tcfg = JTrainConfig(), TrainConfig()
    opt_j = jsolver.make_optimizer(jcfg)
    step_j = jsolver.make_train_step(jcfg, opt_j, depth=8, renderer="oracle")
    pj = jsolver.SceneParams(**{f: jnp.asarray(v) for f, v in p0.items()})
    pj, st, _ = step_j(pj, jnp.asarray(mask), opt_j.init(pj), jcam,
                       jnp.asarray(target))
    p1 = {f: np.asarray(getattr(pj, f)) for f in FIELDS}

    pt = tsolver.SceneParams(*(p.clone().requires_grad_()
                               for p in params_from_numpy(p1, device="cpu")))
    opt_t = tsolver.make_optimizer(tcfg, pt)
    adam_state_from_optax(st, opt_t, pt)
    step_t = tsolver.make_train_step(tcfg, opt_t, depth=8, renderer="oracle",
                                     max_candidates=256)
    pj2, st2, mj = step_j(pj, jnp.asarray(mask), st, jcam,
                          jnp.asarray(target))
    mt = step_t(pt, torch.from_numpy(mask), tcam, torch.from_numpy(target))

    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(mt["psnr"]), float(mj["psnr"]),
                               rtol=1e-4)
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
        adam = st2.inner_states[f].inner_state[0]
        mu_j = np.abs(np.asarray(getattr(adam.mu, f)))
        big = mu_j > 0.01 * mu_j.max()
        assert big.mean() > 0.1, f
        assert np.quantile(diff[big], 0.99) < 0.05, f
        assert diff[big].max() < 0.1 and diff.max() < 2, f
        assert got[f]["count"] == int(adam.count) == 2
        for key in ("mu", "nu"):
            q, worst = _q(got[f][key], np.asarray(getattr(getattr(adam, key),
                                                          f)))
            assert q < 5e-3 and worst < 0.2, (f, key, q, worst)


def test_oracle_render_never_imports_jax(scene_path, tmp_path):
    """render --renderer oracle through the CLI in a fresh interpreter
    where importing jax or rtgs_tpu fails."""
    out = tmp_path / "nojax.png"
    code = (
        "import sys\n"
        "for m in list(sys.modules):\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'rtgs_tpu'):\n"
        "        del sys.modules[m]\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['rtgs_tpu'] = None\n"
        "from rtgs_tpu_torch.__main__ import main\n"
        f"main(['render', '-o', {str(scene_path)!r}, '-r', '32,24', "
        f"'-d', '4', '--device', 'cpu', '--renderer', 'oracle', "
        f"'--output', {str(out)!r}])\n"
        "assert not any(m.split('.')[0] in ('jax', 'jaxlib') and "
        "sys.modules[m] is not None for m in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "Rendered 32x24" in res.stdout
