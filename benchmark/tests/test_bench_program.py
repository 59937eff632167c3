"""The ``program`` reader on a hand-made record of the port's spans and
counters: totals over the ``per`` spans, the host or the stream clock, and
nothing where the port keeps no record or the span, its clock or the
counter never ran. And one traced frame's record on the CPU, read through
the metric files."""

import json
import pathlib

import pytest
import torch

from benchmark.readers import program
from rtgs_tpu_torch.utils import profiling

METRICS = pathlib.Path(__file__).resolve().parents[1] / "metrics"

RECORD = {
    "spans": {
        "render": {"count": 4, "host_ms": 100.0, "stream_ms": 96.0},
        "render.binning": {"count": 4, "host_ms": 10.0, "stream_ms": 26.0},
        "render.entry_lb": {"count": 4, "host_ms": 1.0, "stream_ms": None},
    },
    "counters": {"binning.live_pairs": 1000},
    "records": [],
}


@pytest.fixture
def record(monkeypatch):
    monkeypatch.setattr(profiling, "read", lambda: RECORD)


@pytest.mark.parametrize("spec, want", [
    ({"span": "render", "clock": "host", "per": "render"}, 25.0),
    ({"span": "render.binning", "clock": "stream", "per": "render"}, 6.5),
    ({"span": "render.binning", "clock": "host", "per": "render"}, 2.5),
    ({"counter": "binning.live_pairs", "per": "render"}, 250.0),
    ({"span": "render.entry_lb", "clock": "stream", "per": "render"}, None),
    ({"span": "render.peel", "clock": "stream", "per": "render"}, None),
    ({"counter": "binning.dropped_pairs", "per": "render"}, None),
    ({"span": "fit.loss", "clock": "stream", "per": "fit.step"}, None),
], ids=["host", "stream", "host-of-child", "counter", "no-stream",
        "never-ran", "no-counter", "no-per"])
def test_reader_totals_over_per(record, spec, want):
    assert program.read(spec, None) == want


def test_reader_without_a_record(monkeypatch):
    """A port whose profiling module has no record (the parent of the
    spans) reads as nothing, whatever the metric."""
    monkeypatch.delattr(profiling, "read")
    assert program.read({"span": "render", "clock": "host",
                         "per": "render"}, None) is None


def test_metric_files_read_a_profiled_frame():
    """The render metrics' files read one profiled CPU frame of the keys
    path: every one finds its span or counter, once a frame; stream ms
    read nothing on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    from rtgs_tpu_torch.camera import camera_from_fov
    from rtgs_tpu_torch.render.api import render
    from rtgs_tpu_torch.scene import random_scene

    g = random_scene(300, extent=0.5, seed=1, device="cpu")
    cam = camera_from_fov([0.0, 0.0, 3.0], [0.0, 0.0, 0.0, 1.0], (32, 32),
                          60.0, device="cpu")
    profiling.clear()
    try:
        with torch.inference_mode(), \
                profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                render(g, cam, depth=4, renderer="keys", max_candidates=64,
                       max_global=16)
        got = {p.stem: program.read(json.loads(p.read_text()), None)
               for p in METRICS.glob("*.render.json")
               if json.loads(p.read_text())["reader"] == "program"}
    finally:
        profiling.clear()
    assert set(got) == {"frame_host_ms.render", "binning_stream_ms.render",
                        "features_stream_ms.render",
                        "entry_lb_stream_ms.render", "live_pairs.render"}
    assert got["frame_host_ms.render"] > 0
    assert got["live_pairs.render"] > 0
    assert all(v is None for k, v in got.items() if "stream" in k)
