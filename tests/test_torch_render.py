"""The port's keys-path render (rtgs_tpu_torch.render.tiled.
render_tiled_keys) against the JAX package's, its entry points (render,
render_progressive, the CLI), and a run with JAX made unimportable."""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtgs_tpu import gaussians as JG
from rtgs_tpu.camera import camera_from_fov
from rtgs_tpu.render.tiled import render_tiled_keys as j_render_tiled_keys
from rtgs_tpu.viewer.orbit import orbit_camera_pose
from rtgs_tpu_torch.__main__ import main
from rtgs_tpu_torch.bridge import camera_from_numpy, gaussians_from_numpy
from rtgs_tpu_torch.render.api import render, render_progressive
from rtgs_tpu_torch.render.oracle import render_oracle
from rtgs_tpu_torch.render.tiled import render_tiled_keys
from rtgs_tpu_torch.scene import random_scene, random_scene_arrays, save_scene
from tests._utils import assert_images_close

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _scene_and_camera(n=600, res=(64, 48), seed=11):
    fields = random_scene_arrays(n, 1.0, (0.02, 0.1), seed=seed)
    jg = JG.Gaussians(**{k: jnp.asarray(v) for k, v in fields.items()})
    pos, rot, _, _ = orbit_camera_pose(0.3, 1.2, 3.0, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    jcam = camera_from_fov(pos, rot, res, 60.0)
    return (jg, jcam, gaussians_from_numpy(fields, device="cpu"),
            camera_from_numpy(jcam, device="cpu"))


KW = dict(depth=16, tile=(16, 16), max_candidates=640, max_global=64)


def test_render_matches_jax():
    jg, jcam, tg, tcam = _scene_and_camera()
    img_j = np.asarray(j_render_tiled_keys(jg, jcam, **KW))
    img_t = render_tiled_keys(tg, tcam, **KW)
    assert img_t.shape == (64, 48, 3) and img_t.dtype == torch.float32
    assert torch.isfinite(img_t).all() and img_t.abs().max() > 0.1
    # Same selection; the f32 quadratic is evaluated in a different order,
    # which flips hit/miss on a few grazing silhouette pixels — the
    # statistical image tolerance of the JAX package's own tests.
    assert_images_close(img_t.numpy(), img_j)


def test_bands_identical():
    _, _, tg, tcam = _scene_and_camera(n=300)
    a = render_tiled_keys(tg, tcam, **KW)
    b = render_tiled_keys(tg, tcam, tile_bands=3, **KW)
    assert torch.equal(a, b)


def test_stats_match_jax():
    jg, jcam, tg, tcam = _scene_and_camera(n=400, res=(48, 32))
    kw = dict(KW, max_candidates=96, max_global=8)
    _, js = j_render_tiled_keys(jg, jcam, with_stats=True, **kw)
    _, ts = render_tiled_keys(tg, tcam, with_stats=True, **kw)
    assert set(ts) == set(js)
    for k in js:
        assert int(ts[k]) == int(js[k]), k
    assert int(ts["local_overflow"]) > 0


def test_render_dispatch():
    """At 200 splats ``auto`` is the oracle (the JAX rule: at most 4096
    splats); ``keys`` is the keys path at every size."""
    _, _, tg, tcam = _scene_and_camera(n=200, res=(32, 32))
    ref = render_tiled_keys(tg, tcam, **KW)
    oracle = render_oracle(tg, tcam, depth=KW["depth"])
    assert torch.equal(render(tg, tcam, renderer="auto", **KW), oracle)
    assert torch.equal(render(tg, tcam, renderer="keys", **KW), ref)
    # Without jitter every sample is the pixel-center render.
    assert torch.equal(render_progressive(tg, tcam, samples=3, **KW), oracle)
    jit = render_progressive(tg, tcam, samples=2, jitter=True,
                             generator=torch.Generator().manual_seed(1), **KW)
    assert torch.isfinite(jit).all() and not torch.equal(jit, oracle)
    for name in ("oracle", "tiled"):
        other = render(tg, tcam, renderer=name, **KW)
        assert other.shape == ref.shape and torch.isfinite(other).all()
    fused = render(tg, tcam, renderer="pallas", **KW)
    assert fused.shape == ref.shape and torch.isfinite(fused).all()


@pytest.fixture
def scene_path(tmp_path):
    path = tmp_path / "toy.ply"
    save_scene(path, random_scene(64, extent=0.4, seed=3, device="cpu"))
    return path


def test_cli_render(scene_path, tmp_path, capsys):
    out = tmp_path / "frame.png"
    main(["render", "-o", str(scene_path), "-r", "64,48", "-d", "8",
          "--radius", "2.0", "--device", "cpu", "--output", str(out)])
    assert out.exists() or out.with_suffix(".npy").exists()
    assert "Rendered 64x48 (64 splats, depth 8)" in capsys.readouterr().out


def test_cli_orbit(scene_path, tmp_path):
    outdir = tmp_path / "frames"
    main(["orbit", "-o", str(scene_path), "-r", "32,24", "-d", "4",
          "--frames", "2", "--device", "cpu", "--output", str(outdir)])
    assert sorted(p.stem for p in outdir.iterdir()) == [
        "frame_0000", "frame_0001"]


def test_cli_refuses_missing_cuda(scene_path, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["render", "-o", str(scene_path), "-r", "32,24",
              "--output", str(tmp_path / "x.png")])


def test_port_never_imports_jax(scene_path, tmp_path):
    """Render through the CLI in a fresh interpreter where importing jax
    or rtgs_tpu fails."""
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
        f"'-d', '4', '--device', 'cpu', '--output', {str(out)!r}])\n"
        "assert not any(m.split('.')[0] in ('jax', 'jaxlib') and "
        "sys.modules[m] is not None for m in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "Rendered 32x24" in res.stdout
