"""The port's viewer pieces against the JAX package's: the three quaternion
functions the viewer's orbit math rests on (the cases of
tests/test_quaternion.py), the configuration dataclasses, the progressive
sampler (the cases of tests/test_progressive.py), ``pad_scene``, the PNG
helpers and the ``serve`` HTTP round trip (tests/test_cli.py), in process
and through the port's CLI."""

import argparse
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtgs_tpu import config as jconfig
from rtgs_tpu import gaussians as JG
from rtgs_tpu.camera import camera_from_fov
from rtgs_tpu.render.api import ProgressiveSampler as JSampler
from rtgs_tpu.scene import pad_scene as j_pad_scene
from rtgs_tpu.utils import quaternion as jquat
from rtgs_tpu.viewer.orbit import orbit_camera_pose
from rtgs_tpu_torch import config as tconfig
from rtgs_tpu_torch.__main__ import main
from rtgs_tpu_torch.bridge import camera_from_numpy, gaussians_from_numpy
from rtgs_tpu_torch.camera import image_to_display
from rtgs_tpu_torch.render.api import (ProgressiveSampler, render,
                                       render_progressive)
from rtgs_tpu_torch.scene import (pad_scene, random_scene,
                                  random_scene_arrays, save_scene)
from rtgs_tpu_torch.utils import quaternion as quat
from rtgs_tpu_torch.utils.image import decode_png, encode_png, to_uint8
from rtgs_tpu_torch.viewer.server import make_server

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-5


def _unit_quats(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# --- quaternions (tests/test_quaternion.py:36,45,54,88) ---------------------

def test_inv_roundtrip_unit():
    q = _unit_quats(16, 1)
    out = quat.mul(torch.from_numpy(q), quat.inv(torch.from_numpy(q)))
    np.testing.assert_allclose(out.numpy(),
                               np.tile([0.0, 0.0, 0.0, 1.0], (16, 1)),
                               atol=1e-6)
    # Non-unit quaternions keep the reference's division by |q|.
    qn = 2.5 * q
    np.testing.assert_allclose(quat.inv(torch.from_numpy(qn)).numpy(),
                               np.asarray(jquat.inv(jnp.asarray(qn))),
                               rtol=RTOL)


def test_axis_angle_roundtrip():
    v = np.random.default_rng(2).normal(size=(32, 3)).astype(np.float32)
    out = quat.as_axis_angle(quat.from_axis_angle(torch.from_numpy(v)))
    sel = np.linalg.norm(v, axis=-1) < np.pi
    np.testing.assert_allclose(out.numpy()[sel], v[sel], atol=1e-4)
    ref = jquat.as_axis_angle(jquat.from_axis_angle(jnp.asarray(v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_zero_axis_angle():
    q = quat.from_axis_angle(torch.zeros(3))
    np.testing.assert_allclose(q.numpy(), [0.0, 0.0, 0.0, 1.0], atol=1e-7)
    np.testing.assert_allclose(quat.as_axis_angle(q).numpy(), [0.0] * 3,
                               atol=1e-7)
    np.testing.assert_array_equal(
        quat.as_axis_angle(q).numpy(),
        np.asarray(jquat.as_axis_angle(jnp.asarray(q.numpy()))))


def test_rotation_mat4():
    q = _unit_quats(8, 3)
    m4 = quat.as_rotation_mat4(torch.from_numpy(q)).numpy()
    m3 = quat.as_rotation_mat3(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(m4[:, :3, :3], m3, atol=1e-6)
    np.testing.assert_allclose(m4[:, 3, 3], np.ones(8))
    np.testing.assert_allclose(m4[:, 3, :3], np.zeros((8, 3)))
    np.testing.assert_allclose(m4[:, :3, 3], np.zeros((8, 3)))
    np.testing.assert_allclose(
        m4, np.asarray(jquat.as_rotation_mat4(jnp.asarray(q))), atol=1e-6)


# --- configuration ----------------------------------------------------------

@pytest.mark.parametrize("name", ["RenderConfig", "SceneConfig",
                                  "MeshConfig", "TrainConfig"])
def test_config_defaults_match_jax(name):
    ours, ref = getattr(tconfig, name)(), getattr(jconfig, name)()
    assert ([f.name for f in dataclasses.fields(ours)]
            == [f.name for f in dataclasses.fields(ref)])
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_config_nests_the_four():
    ours, ref = tconfig.Config(), jconfig.Config()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert not hasattr(tconfig, "KernelConfig")


# --- progressive sampling (tests/test_progressive.py:24,35,49,70) ----------

def _scene_camera(n=150, res=(32, 32)):
    fields = random_scene_arrays(n, 0.8, (0.02, 0.1), seed=42)
    pos, rot, _, _ = orbit_camera_pose(0.3, 1.2, 3.0, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    jcam = camera_from_fov(pos, rot, res, 60.0)
    jg = JG.Gaussians(**{k: jnp.asarray(v) for k, v in fields.items()})
    return (jg, jcam, gaussians_from_numpy(fields, device="cpu"),
            camera_from_numpy(jcam, device="cpu"))


def test_no_jitter_samples_equal_single_render():
    _, _, g, cam = _scene_camera()
    one = render(g, cam, depth=8)
    assert torch.equal(render_progressive(g, cam, depth=8, samples=4), one)


def test_sampler_accumulates_and_displays():
    """Three identical samples display the single render (to the f32
    add/divide round trip), and, through the oracle, the JAX sampler's
    display to 1e-5."""
    jg, jcam, g, cam = _scene_camera()
    s = ProgressiveSampler(g, cam, depth=8, renderer="oracle")
    s.sample().sample().sample()
    assert s.num_samples == 3
    one = render(g, cam, depth=8, renderer="oracle")
    np.testing.assert_allclose(s.display().numpy(), one.numpy(), rtol=0,
                               atol=1e-6)
    js = JSampler(jg, jcam, depth=8, renderer="oracle")
    js.sample().sample().sample()
    np.testing.assert_allclose(s.display().numpy(), np.asarray(js.display()),
                               atol=1e-5)
    s.clear()
    assert s.num_samples == 0
    with pytest.raises(RuntimeError, match="no samples"):
        s.display()


def test_jittered_sampling_antialiases():
    """With jitter, the first sample is the centered render and later ones
    differ; N samples display what render_progressive returns for N jittered
    samples from a generator of the same seed."""
    _, _, g, cam = _scene_camera()
    one = render(g, cam, depth=8)
    aa = render_progressive(g, cam, depth=8, samples=4, jitter=True,
                            generator=torch.Generator().manual_seed(7))
    assert torch.isfinite(aa).all()
    assert not torch.equal(aa, one)
    assert (aa - one).abs().mean() < 0.05
    s = ProgressiveSampler(g, cam, depth=8, jitter=True,
                           generator=torch.Generator().manual_seed(7))
    s.sample()
    assert torch.equal(s.display(), one)
    s.sample().sample().sample()
    assert torch.equal(s.display(), aa)


def test_cli_sample_flag(tmp_path):
    """-s 4 without jitter writes the same PNG as -s 1."""
    ply = tmp_path / "s.ply"
    save_scene(ply, random_scene(64, extent=0.5, seed=1, device="cpu"))
    outs = []
    for samples in ("1", "4"):
        out = tmp_path / f"s{samples}.png"
        main(["render", "-o", str(ply), "-r", "32,32", "-s", samples,
              "--radius", "2.0", "--device", "cpu", "--output", str(out)])
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


# --- pad_scene --------------------------------------------------------------

@pytest.mark.parametrize("multiple", [1, 4, 7])
def test_pad_scene_matches_jax(multiple):
    fields = random_scene_arrays(10, seed=3)
    jg = JG.Gaussians(**{k: jnp.asarray(v) for k, v in fields.items()})
    got = pad_scene(gaussians_from_numpy(fields, device="cpu"), multiple)
    ref = j_pad_scene(jg, multiple)
    assert got.num == ref.num == -(-10 // multiple) * multiple
    for f in ("means", "quats", "scales", "colors", "opacities", "sh",
              "mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


# --- PNG and the viewer ------------------------------------------------------

def test_png_roundtrip():
    arr = np.random.default_rng(0).integers(0, 256, (5, 7, 3), np.uint8)
    png = encode_png(arr)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(decode_png(png), arr)


def _get(port, path):
    for _ in range(100):
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=30) as r:
                return r.read()
        except OSError:
            time.sleep(0.2)
    raise RuntimeError("server did not come up")


def _post(port, body: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/event",
                                 data=body, method="POST")
    try:
        return urllib.request.urlopen(req, timeout=30).status
    except urllib.error.HTTPError as e:
        return e.code


def test_viewer_session_in_process():
    """``make_server`` on a free port: the page, a frame bitwise the
    in-process render of the session's pose, a cached frame rendered once,
    each event a new frame, a bad event answered 400."""
    _, _, g, _ = _scene_camera(n=120, res=(40, 24))
    args = argparse.Namespace(res=(40, 24), fov=60.0, depth=8,
                              renderer="keys", radius=2.5, port=0)
    server, session = make_server(
        g, args, render_kwargs=dict(max_candidates=256))
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    renders = []
    inner = session._render

    def counted():
        renders.append(1)
        return inner()
    session._render = counted
    try:
        assert b"rtgs-tpu viewer" in _get(port, "/")
        frame = _get(port, "/frame?v=0")
        with torch.inference_mode():
            ref = render(g, session.camera(), depth=8, renderer="keys",
                         max_candidates=256)
        np.testing.assert_array_equal(
            decode_png(frame), to_uint8(image_to_display(ref).numpy()))
        assert set(session.timings) == {"render", "encode"}
        assert _get(port, "/frame?v=0") == frame and len(renders) == 1
        seen = [frame]
        for ev in ({"type": "pan", "dx": 0.3, "dy": 0.0},
                   {"type": "zoom", "delta": 1},
                   {"type": "rot", "rx": 0.5, "ry": 0.2, "rz": 0.0}):
            assert _post(port, json.dumps(ev).encode()) == 204
            seen.append(_get(port, "/frame"))
            assert seen[-1] != seen[-2], ev
        assert len(renders) == 4
        assert _post(port, b"not json") == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_cli_serve_http_roundtrip(tmp_path):
    """tests/test_cli.py:72 through the port's CLI: ``serve --port 0
    --device cpu --renderer oracle`` prints the port it took and answers
    ``/``, ``/frame`` and ``/event``, and a pan re-renders the frame."""
    ply = tmp_path / "s.ply"
    save_scene(ply, random_scene(64, extent=0.5, seed=2, device="cpu"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "rtgs_tpu_torch", "serve", "-o", str(ply),
         "-r", "32,24", "-d", "4", "--radius", "2.0", "--renderer",
         "oracle", "--device", "cpu", "--port", "0"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"viewer: http://localhost:(\d+) ", line)
        assert m, line
        port = int(m.group(1))
        assert b"rtgs-tpu viewer" in _get(port, "/")
        frame0 = _get(port, "/frame?v=0")
        assert frame0[:8] == b"\x89PNG\r\n\x1a\n"
        assert decode_png(frame0).shape == (24, 32, 3)
        assert _post(port, b'{"type": "pan", "dx": 0.3, "dy": 0.0}') == 204
        frame1 = _get(port, "/frame?v=1")
        assert frame1[:8] == b"\x89PNG\r\n\x1a\n" and frame1 != frame0
        assert _post(port, b"not json") == 400
    finally:
        proc.terminate()
        proc.communicate(timeout=30)
