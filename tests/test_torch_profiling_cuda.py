"""``utils.profiling.timed`` on the card: it waits for the card when the
result is a dataclass (here ``tile_candidates``' TileBinning), so the time
it reports for a call is no shorter than CUDA events recorded inside that
same call around its device work (the events run within the host interval
when ``timed`` waits; when it returns at the last launch, the card is
still busy). And the spans' stream ms on the card: each span of a
profiled frame holds the stream for a positive time, and the frame's
``render`` span for at least as long as each of its layers. Imports no JAX,
so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_profiling_cuda.py"""

import pytest
import torch

from rtgs_tpu_torch.camera import camera_from_fov
from rtgs_tpu_torch.render.binning import tile_candidates
from rtgs_tpu_torch.scene import random_scene
from rtgs_tpu_torch.utils import profiling as prof


@pytest.mark.cuda
def test_timed_waits_for_the_card_on_a_dataclass():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    g = random_scene(1_000_000, extent=2.0, scale_range=(0.005, 0.03),
                     seed=0, device=dev)
    cam = camera_from_fov([0.0, 0.0, 5.0], [0.0, 0.0, 0.0, 1.0],
                          (1920, 1088), 60.0, device=dev)
    kw = dict(max_candidates=3584, max_global=64)
    tile_candidates(g, cam, **kw)
    torch.cuda.synchronize()
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))

        def binning():
            start.record()
            out = tile_candidates(g, cam, **kw)
            end.record()
            return out

        got = prof.timed(binning, iters=1, warmup=0)
        torch.cuda.synchronize()
        device_s = start.elapsed_time(end) / 1e3
        assert got["median_s"] >= device_s, (got, device_s)


@pytest.mark.cuda
def test_span_stream_ms_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.profiler import ProfilerActivity, profile

    from rtgs_tpu_torch.render.api import render

    dev = torch.device("cuda")
    g = random_scene(100_000, extent=2.0, scale_range=(0.005, 0.03),
                     seed=0, device=dev)
    cam = camera_from_fov([0.0, 0.0, 5.0], [0.0, 0.0, 0.0, 1.0],
                          (512, 384), 60.0, device=dev)
    kw = dict(max_candidates=1536, max_global=128)
    with torch.inference_mode():
        render(g, cam, renderer="pallas", **kw)
        prof.clear()
        with profile(activities=[ProfilerActivity.CUDA]):
            render(g, cam, renderer="pallas", **kw)
            torch.cuda.synchronize()
    spans = prof.read()["spans"]
    prof.clear()
    assert set(spans) == {"render", "render.binning", "render.features",
                          "render.peel", "render.assemble"}
    assert all(s["count"] == 1 and s["stream_ms"] > 0
               for s in spans.values()), spans
    assert all(spans["render"]["stream_ms"] >= s["stream_ms"]
               for s in spans.values()), spans
