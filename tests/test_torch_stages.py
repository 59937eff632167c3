"""The stage and trace probes (rtgs_tpu_torch.probes.stages, trace_step)
run on the CPU at a tiny size: every stage is timed (the host clock
around the plain versions: no device metric), the splits cover their
stages, and the trace of a training step is written where it says and read
back by the summary (no device kernels on the CPU), beside the spans it
reads from the program's record. Their numbers mean something only on the
card (``chip_smoke.py`` phase 21)."""

import json
import math

import pytest
import torch

from rtgs_tpu_torch.probes import _common, stages, trace_step
from rtgs_tpu_torch.scene import random_scene

CPU = torch.device("cpu")


@pytest.mark.parametrize("renderer,bands", [("keys", 0), ("pallas", 2)])
def test_stage_table_runs(renderer, bands, capsys):
    stages.main(["3000", "48", "32", "--cand", "256", "--iters", "1",
                 "--bands", str(bands), "--renderer", renderer,
                 "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = {"binning", "feature pack", "pixel table", "kernel", "full fwd",
            "full step"} | ({"shade+comp"} if renderer == "keys" else set())
    assert set(out["stages_ms"]) == want
    assert all(math.isfinite(v) and v > 0 for v in out["stages_ms"].values())
    assert out["tiles"] == 6 and out["band_tiles"] == (3 if bands else 6)


def test_splits_cover_their_stages():
    from rtgs_tpu_torch.config import TrainConfig
    from rtgs_tpu_torch.train.datasets import synthetic_orbit_dataset
    from rtgs_tpu_torch.train.solver import Solver, init_params

    g = random_scene(3000, device="cpu", **_common.BENCH_SCENE)
    cam = _common.bench_camera((48, 32), CPU)
    kw = dict(max_candidates=256, max_global=128, bin_narrow=None,
              tile_bands=2)
    frame = stages.stage_times(g, cam, kw)
    assert set(frame) == {"features", "entry bound", "binning", "keys",
                          "shade", "composite", "total"}
    assert sum(v for k, v in frame.items() if k != "total") <= \
        frame["total"] + 1e-6
    ds = synthetic_orbit_dataset(g, 2, (48, 32), radius=5.0, depth=8,
                                 renderer="pallas", max_candidates=256)
    solver = Solver(params=init_params(g), mask=g.mask, cfg=TrainConfig(),
                    cameras=ds.cameras, targets=ds.images, depth=8,
                    renderer="pallas",
                    render_kwargs=dict(max_candidates=256))
    before = solver.params.means.detach().clone()
    step = stages.step_stages(solver, dict(max_candidates=256,
                                           max_global=128))
    assert list(step) == ["binning", "features", "peel forward", "loss",
                          "backward", "adam", "total"]
    assert not torch.equal(solver.params.means, before)   # Adam stepped


def test_trace_step_runs(tmp_path):
    out = trace_step.run(n=2000, steps=1, outdir=str(tmp_path), device="cpu",
                         views=2, res=(32, 32), log=lambda m: None)
    assert out["logdir"] == str(tmp_path) and out["files"] >= 1
    assert (tmp_path / "trace.json").stat().st_size == out["bytes"]
    assert set(out["kernels"]) == {g for g, _ in trace_step.GROUPS} | \
        {"other"}
    assert all(v["kernels"] == 0 for v in out["kernels"].values())
    # The program's record of the traced step: one step and its phases,
    # host ms only on the CPU, and the binning's dropped pairs.
    assert {"fit.step", "fit.forward", "fit.loss", "fit.backward",
            "fit.adam", "fit.readback", "render"} <= set(out["spans"])
    assert out["spans"]["fit.step"]["count"] == 1
    assert all(s["host_ms"] > 0 and s["stream_ms"] is None
               for s in out["spans"].values())
    assert out["dropped_pairs"] >= 0
