"""The port's profiling utilities (rtgs_tpu_torch.utils.profiling) against
the JAX package's: ``timed``'s keys and ordering, ``timed`` waiting for
every card a result's tensors lie on (through dataclasses and nested
containers, as ``jax.block_until_ready`` waits on every leaf; on the card
tests/test_torch_profiling_cuda.py), ``Meter.flush``'s
line, and ``trace`` writing a Chrome trace of a render on the CPU into the
log directory it yields."""

import dataclasses
import json
import os
import re
import tempfile
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
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


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a card as its device: a stand-in result
    for ``timed`` where there is no card."""

    index = 0

    @property
    def device(self):
        return torch.device("cuda", self.index)


def _on_card(index: int) -> torch.Tensor:
    x = torch.zeros(2).as_subclass(_OnCard)
    x.index = index
    return x


@dataclasses.dataclass
class _Binning:          # the shape of render/binning.py:TileBinning
    candidates: torch.Tensor
    counts: torch.Tensor
    overflow: int


class _Pair(NamedTuple):
    a: object
    b: object


@pytest.mark.parametrize("make, cards", [
    (lambda: _on_card(0), [0]),
    (lambda: (_on_card(0), _on_card(1)), [0, 1]),
    (lambda: _Binning(_on_card(1), torch.zeros(3), 7), [1]),
    (lambda: ((torch.zeros(1), [_on_card(0)]), {"k": (_on_card(0),)}), [0]),
    (lambda: _Pair({"x": _Binning(_on_card(0), _on_card(1), 0)}, None),
     [0, 1]),
    (lambda: (torch.zeros(1), {"y": [torch.ones(2)]}, "text", 3), []),
], ids=["tensor", "tuple", "dataclass", "nested", "namedtuple-of-dataclass",
        "cpu-only"])
def test_timed_waits_for_every_card_of_the_result(monkeypatch, make, cards):
    """The stand-in result's cards are each synchronized once a call,
    warm-up included, wherever the tensors sit: in a dataclass (the port's
    Gaussians, Camera, TileFeatures, TileBinning), a NamedTuple or nested
    containers. The JAX ``timed`` waits on every leaf of its pytrees
    (rtgs_tpu/utils/profiling.py:28,32)."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: synced.append(dev.index))
    out = make()
    prof.timed(lambda: out, iters=3, warmup=1)
    assert synced == cards * 4


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
    with prof.trace(str(tmp_path / "tr")) as logdir:
        img = render_tiled_keys(g, cam, depth=4)
    assert torch.isfinite(img).all()
    assert logdir == str(tmp_path / "tr")
    path = tmp_path / "tr" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("sort" in n for n in names), sorted(names)[:20]


def test_trace_defaults_to_the_temporary_directory(tmp_path, monkeypatch):
    """Without a logdir, ``trace`` writes under the temporary directory
    (``/tmp`` unless TMPDIR says otherwise; the JAX package's default is
    ``/tmp/rtgs_tpu_trace``) and yields the directory, as the JAX
    ``trace`` yields its logdir."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    with prof.trace() as logdir:
        torch.ones(4).sum()
    assert logdir == os.path.join(str(tmp_path), "rtgs_torch_trace")
    assert json.loads((tmp_path / "rtgs_torch_trace" / "trace.json")
                      .read_text())["traceEvents"]
    with jprof.trace(str(tmp_path / "jax")) as jdir:
        pass
    assert jdir == str(tmp_path / "jax")
