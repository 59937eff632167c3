"""``utils.profiling.timed`` on the card: it waits for the card when the
result is a dataclass (here ``tile_candidates``' TileBinning), so the time
it reports for a call is no shorter than CUDA events recorded inside that
same call around its device work (the events run within the host interval
when ``timed`` waits; when it returns at the last launch, the card is
still busy). Imports no JAX, so it runs where only the port is installed:

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
