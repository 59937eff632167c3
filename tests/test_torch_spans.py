"""The port's spans and counters (rtgs_tpu_torch.utils.profiling.span,
count, read, clear) on the CPU: with no profiler recording they record
nothing and never reach ``record_function``; under a profiler a frame of
either tiled renderer and a training step record their layers as children
of one top span, in the Chrome trace too; the binning's counters equal what
its result holds; a count runs no torch operation. Stream ms on the card:
tests/test_torch_profiling_cuda.py."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from rtgs_tpu_torch.camera import camera_from_fov
from rtgs_tpu_torch.config import TrainConfig
from rtgs_tpu_torch.render.api import render
from rtgs_tpu_torch.render.binning import tile_candidates
from rtgs_tpu_torch.scene import random_scene
from rtgs_tpu_torch.train.solver import Solver, init_params
from rtgs_tpu_torch.utils import profiling as prof

CPU = torch.device("cpu")
BUDGETS = dict(max_candidates=64, max_global=16)
FRAME_LAYERS = {
    "keys": ["render.features", "render.entry_lb", "render.binning",
             "render.features", "render.keys_shade", "render.assemble"],
    "pallas": ["render.binning", "render.features", "render.peel",
               "render.assemble"],
}
FIT_PHASES = ["fit.forward", "fit.loss", "fit.backward", "fit.adam",
              "fit.readback"]


@pytest.fixture(autouse=True)
def empty_record():
    prof.clear()
    yield
    prof.clear()


def _scene(n=300):
    return random_scene(n, extent=0.5, seed=1, device=CPU)


def _camera(res=(32, 32)):
    return camera_from_fov([0.0, 0.0, 3.0], [0.0, 0.0, 0.0, 1.0], res, 60.0,
                           device=CPU)


def _solver(renderer="pallas"):
    g = _scene()
    cam = _camera((16, 16))
    with torch.no_grad():
        target = render(g, cam, depth=4, renderer=renderer, **BUDGETS)
    return Solver(params=init_params(g), mask=g.mask,
                  cfg=TrainConfig(densify_every=0, opacity_reset_every=0,
                                  checkpoint_every=0),
                  cameras=[cam], targets=[target], depth=4,
                  renderer=renderer, render_kwargs=dict(BUDGETS))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


@pytest.mark.parametrize("what", ["keys-frame", "train-step"])
def test_no_profiler_records_nothing(monkeypatch, what):
    """With no profiler recording, a frame and a training step leave the
    record empty and open no ``rtgs.*`` annotation: ``record_function``
    raises on one."""
    orig = torch.profiler.record_function

    def guarded(name, *args, **kwargs):
        if name.startswith(prof.PREFIX):
            raise AssertionError(f"span {name} entered record_function")
        return orig(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", guarded)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", guarded)
    if what == "keys-frame":
        img = render(_scene(), _camera(), depth=4, renderer="keys",
                     **BUDGETS)
        assert torch.isfinite(img).all()
    else:
        solver = _solver()
        assert torch.isfinite(torch.tensor(solver.train_step()["loss"]))
    assert prof.read() == {"spans": {}, "counters": {}, "records": []}


@pytest.mark.parametrize("renderer", ["keys", "pallas"])
def test_profiled_frame_nests_its_layers(renderer):
    """Under a profiler one frame is a ``render`` top span whose children
    are the renderer's layers in order, all with the frame's top id; on the
    CPU no span has stream ms."""
    _profiled(lambda: render(_scene(), _camera(), depth=4, renderer=renderer,
                             tile_bands=2, **BUDGETS))
    recs = prof.read()["records"]
    assert recs[0]["name"] == "render" and recs[0]["parent"] is None
    assert [r["name"] for r in recs[1:]] == FRAME_LAYERS[renderer]
    assert all(r["parent"] == "render" for r in recs[1:])
    assert len({r["top"] for r in recs}) == 1
    assert all(r["host_ms"] > 0 and r["stream_ms"] is None for r in recs)
    assert recs[0]["host_ms"] >= sum(r["host_ms"] for r in recs[1:])


def test_chrome_trace_holds_the_spans(tmp_path):
    """``utils.profiling.trace`` (the operator's switch) writes the spans
    into its Chrome trace as ``rtgs.*`` user annotations."""
    with prof.trace(str(tmp_path)):
        render(_scene(), _camera(), depth=4, renderer="pallas", **BUDGETS)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events
             if e.get("cat") == "user_annotation"
             and e["name"].startswith(prof.PREFIX)}
    assert names == {prof.PREFIX + n
                     for n in ["render"] + FRAME_LAYERS["pallas"]}
    assert prof.read()["spans"]["render"]["count"] == 1


def test_train_step_records_its_phases_in_order():
    """A profiled step is one ``fit.step`` with its phases as children in
    order, the frame's ``render`` span under ``fit.forward``, one top id;
    the totals count one of each."""
    solver = _solver()
    solver.train_step()
    _profiled(solver.train_step)
    got = prof.read()
    recs = got["records"]
    assert recs[0]["name"] == "fit.step" and recs[0]["parent"] is None
    assert [r["name"] for r in recs if r["parent"] == "fit.step"] == \
        FIT_PHASES
    assert [r["parent"] for r in recs if r["name"] == "render"] == \
        ["fit.forward"]
    assert len({r["top"] for r in recs}) == 1
    assert all(got["spans"][n]["count"] == 1 for n in ["fit.step"]
               + FIT_PHASES)


def test_binning_counters_match_the_binning():
    """The counters hold the binning's live pairs, ``(candidates >=
    0).sum()``, and its dropped pairs, ``local_overflow +
    global_overflow``, summed over the calls; tight budgets drop pairs."""
    g, cam = _scene(), _camera()
    kw = dict(max_candidates=8, max_global=2)
    bins = _profiled(lambda: [tile_candidates(g, cam, **kw),
                              tile_candidates(g, cam, chunk=8, **kw)])
    counters = prof.read()["counters"]
    live = sum(int((b.candidates >= 0).sum()) for b in bins)
    dropped = sum(int(b.local_overflow + b.global_overflow) for b in bins)
    assert dropped > 0
    assert counters == {"binning.live_pairs": live,
                        "binning.dropped_pairs": dropped}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_count_runs_no_torch_op():
    """A count keeps the tensor by reference (no operation runs, nothing
    waits); the reading sums it, with host numbers added as they came."""
    x = torch.arange(6)
    ops = _Ops()
    with profile(activities=[ProfilerActivity.CPU]), ops:
        prof.count("c", x)
        prof.count("c", 4)
    assert ops.ops == []
    assert prof.read()["counters"] == {"c": 15 + 4}
    x.zero_()                              # reduced once, at the reading
    assert prof.read()["counters"] == {"c": 19}


def test_clear_empties_the_record():
    _profiled(lambda: render(_scene(), _camera(), depth=4, renderer="pallas",
                             **BUDGETS))
    assert prof.read()["spans"] and prof.read()["counters"]
    prof.clear()
    assert prof.read() == {"spans": {}, "counters": {}, "records": []}


def test_spans_off_share_one_null_context():
    """With no profiler, a span is the one shared null context (nothing is
    made a span) and a count keeps nothing; under one, each is live."""
    assert prof.span("a") is prof.span("b", CPU)
    prof.count("c", torch.ones(3))
    assert prof.read()["counters"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        live = prof.span("a")
        assert live is not prof.span("a")
        with live:
            pass
    assert prof.read()["spans"]["a"]["count"] == 1


@pytest.mark.parametrize("tile_bands", [4, None])
def test_band_backwards_record_spans_and_counters(monkeypatch, tile_bands):
    """Each band's backward of the fused path is one ``peel.backward`` span
    under ``fit.backward``, and counts one band, the (N+1)-row table
    gradient it writes and the pair rows its stage 2 reduces (Σ of the
    band's tiles' candidate counts, ``ops.peel._counts``): a step of 8 tiles
    in 4 bands records 4 of each, an unbanded step 1."""
    import rtgs_tpu_torch.render.tiled as tiled
    from rtgs_tpu_torch.ops.peel import CHUNK, _counts

    g = _scene()
    cam = _camera((64, 32))
    kw = dict(BUDGETS, tile_bands=tile_bands)
    with torch.no_grad():
        target = render(g, cam, depth=4, renderer="pallas", **kw)
    solver = Solver(params=init_params(g), mask=g.mask,
                    cfg=TrainConfig(densify_every=0, opacity_reset_every=0,
                                    checkpoint_every=0),
                    cameras=[cam], targets=[target], depth=4,
                    renderer="pallas", render_kwargs=kw)
    bins, orig = [], tiled.tile_candidates

    def kept(*args, **kwargs):
        bins.append(orig(*args, **kwargs))
        return bins[-1]

    monkeypatch.setattr(tiled, "tile_candidates", kept)
    _profiled(solver.train_step)
    (b,) = bins
    cand = torch.nn.functional.pad(
        b.candidates, (0, (-b.candidates.shape[1]) % CHUNK), value=-1)
    assert cand.shape[0] == 8
    bands = 4 if tile_bands else 1
    got = prof.read()
    spans = [r for r in got["records"] if r["name"] == "peel.backward"]
    assert len(spans) == bands
    assert all(r["parent"] == "fit.backward" for r in spans)
    assert got["counters"]["peel.backward_bands"] == bands
    assert got["counters"]["peel.table_grad_rows"] == bands * (g.num + 1)
    assert got["counters"]["peel.winner_rows"] == int(_counts(cand).sum())
    assert int(_counts(cand).sum()) > 0


@pytest.mark.parametrize("depth,per_band", [(16, 0), (65, 1), (128, 2)])
def test_deep_passes_count_per_band(depth, per_band):
    """``peel.deep_passes`` counts each pass of more than 16 layers, on the
    twin as on the card: at depth 128 two a band, at 65 one (its second
    pass holds one layer), at 16 none."""
    g = _scene()
    _profiled(lambda: render(g, _camera((64, 32)), depth=depth,
                             renderer="pallas", tile_bands=4, **BUDGETS))
    got = prof.read()["counters"].get("peel.deep_passes", 0)
    assert got == 4 * per_band
