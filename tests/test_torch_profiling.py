"""The port's profiling utilities (rtgs_tpu_torch.utils.profiling) against
the JAX package's: ``timed``'s keys and ordering, ``Meter.flush``'s line,
and ``trace`` writing a Chrome trace of a render on the CPU."""

import json
import re

import jax.numpy as jnp
import numpy as np
import torch

from rtgs_tpu.utils import profiling as jprof
from rtgs_tpu_torch.camera import camera_from_fov
from rtgs_tpu_torch.render.tiled import render_tiled_keys
from rtgs_tpu_torch.scene import random_scene
from rtgs_tpu_torch.utils import profiling as prof


def test_timed_keys_match_jax():
    x = torch.ones(64)
    got = prof.timed(lambda: x * 2.0, iters=3, rays=1000, label="mul")
    ref = jprof.timed(lambda: jnp.ones(64) * 2.0, iters=3, rays=1000)
    assert set(got) == set(ref) == {"median_s", "min_s", "max_s",
                                    "rays_per_s"}
    assert 0 < got["min_s"] <= got["median_s"] <= got["max_s"]
    assert np.isclose(got["rays_per_s"], 1000 / got["median_s"])
    assert set(prof.timed(lambda: (x, {"y": x}), iters=1)) == {
        "median_s", "min_s", "max_s"}


def test_meter_flush_matches_jax():
    """The same updates give the same line, apart from the times."""
    ours, ref = prof.Meter(), jprof.Meter()
    for m in (ours, ref):
        m.update(loss=0.5, psnr=20.0)
        m.update(loss=0.25, psnr=22.0)
    a, b = ours.flush(7, rays_per_step=1000), ref.flush(7, rays_per_step=1000)
    times = r"[\d.]+ ms/step|[\d.]+M rays/s"
    assert (re.sub(times, "T", a) == re.sub(times, "T", b)
            == "step 7 T T loss=0.375 psnr=21")
    assert ours.flush(8).startswith("step 8 ")   # reset after a flush


def test_trace_writes_chrome_trace(tmp_path):
    g = random_scene(200, extent=0.5, seed=1, device="cpu")
    cam = camera_from_fov([0.0, 0.0, 3.0], [0.0, 0.0, 0.0, 1.0], (32, 32),
                          60.0, device="cpu")
    with prof.trace(str(tmp_path / "tr")):
        img = render_tiled_keys(g, cam, depth=4)
    assert torch.isfinite(img).all()
    path = tmp_path / "tr" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("sort" in n for n in names), sorted(names)[:20]
