"""The blocked reference of the 1M re-fit (``reference/train_blocked.py``)
against the one-graph reference (``reference/train.py:steps``), and a CPU
rehearsal of the cell ``fit1m_refit`` in bands: sound, it is correct under
the cell's limits; with one band's table gradient zeroed it fails
``grad_gap``.

Sizes are cut for a test run: 2,000 splats of scales 0.05-0.2 at 64×48
for the references (so that pixels meet more layers than the depth, 16);
6,000 splats of the cell's law at 64×48 in 4 bands of 3 tiles, 3 views,
for the rehearsal, whose ``auto`` is named ``pallas``, the path it takes on
the card (the port's plain twins run it here). The limits are the cell's."""

import pytest
import torch

from benchmark import run as H
from benchmark import scene as S
from benchmark.reference import render as R
from benchmark.reference import train as T
from benchmark.reference import train_blocked as TB

CELL = "fit1m_refit"


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def tiny(n: int = 6000, bands: int = 4) -> dict:
    cell = H.load_cell(CELL)
    cfg, mix = cell["config_data"], cell["mix"]
    cfg["scene"]["n"] = n
    cfg["camera"]["res"] = [64, 48]
    cfg["render"].update(max_candidates=2048, max_global=2048,
                         tile_bands=bands)
    mix.update(renderer="pallas", views=3, warmup_steps=3, block_pixels=512)
    return cell


def reference_inputs(seed: int, clamp: bool = False):
    """The workload's start, cameras and float64 targets of its first
    steps, at 2,000 splats of scales 0.05-0.2, the start's log-scales
    clamped into that range or not."""
    cell = tiny(n=2000)
    cell["config_data"]["scene"]["scale_range"] = [0.05, 0.2]
    cell["mix"]["clamp_log_scales"] = clamp
    w = H.workload(cell, seed, "cpu")
    w.fields = S.uniform_scene(cell["config_data"], seed, "cpu")
    w.raw0 = w.raw_start()
    n = int(w.mix["check_steps"])
    cams = w._ref_cameras(n)
    targets = [R.render(w.fields, c, w.depth) for c in cams]
    return w, cams, targets


@pytest.mark.parametrize("block", [512, 48], ids=["512px", "one-row"])
@pytest.mark.parametrize("clamp", [False, True], ids=["free", "clamped"])
def test_blocked_steps_equal_one_graph(block, clamp):
    """Every loss, first-gradient norm and change norm of the blocked
    reference equals the one-graph reference's to 1e-10 relative, with
    blocks of 512 pixels and of one row of the (W, H) pixel grid (48).

    With the start's log-scales clamped, a splat can have all three scales
    at a bound: it is a sphere, its quaternion's gradient is zero but for
    round-off, which differs with the order of the sums, and Adam turns
    round-off of either sign into a whole step (±lr). So there the change
    of ``quats`` is compared only to 1e-6, and the rest to 1e-10."""
    w, cams, targets = reference_inputs(2**31 + 11, clamp)
    args = (w.raw0, targets, cams, w.depth, w.mix["lr"],
            w.mix["lambda_dssim"], len(cams))
    want = T.steps(*args)
    got = TB.steps_blocked(*args, block_pixels=block)
    assert len(got["losses"]) == len(want["losses"]) == 3
    for g, r in zip(got["losses"], want["losses"]):
        assert abs(g - r) <= 1e-10 * abs(r)
    for key in ("grad_norms", "change_norms"):
        assert set(got[key]) == set(T.LEAVES)
        for k in T.LEAVES:
            tol = 1e-6 if clamp and (key, k) == ("change_norms",
                                                 "quats") else 1e-10
            assert want[key][k] > 0, (key, k)
            assert abs(got[key][k] - want[key][k]) <= tol * want[key][k], \
                (key, k, got[key][k], want[key][k])
    # Deep pixels: the depth binds somewhere, so the layers' order matters.
    winners = R.select(R.frame_fields(w.fields, torch.float64), cams[0],
                       w.depth, "cpu")
    assert bool((winners[..., -1] >= 0).any())


def test_blocked_steps_restore_the_one_graph_frame():
    w, cams, targets = reference_inputs(5)
    orig = T.render_raw
    TB.steps_blocked(w.raw0, targets[:1], cams[:1], w.depth, w.mix["lr"],
                     w.mix["lambda_dssim"], 1, block_pixels=1024)
    assert T.render_raw is orig


def test_banded_rehearsal_is_correct():
    out = H.run_cell(tiny(), 2**31 + 7, 0.5, False, "cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"step_ms", "setup_s"}


def test_one_band_zeroed_fails_grad_gap(monkeypatch):
    """A fault in one band's backward: the table gradient of every fourth
    band backward (one band a step) is zeros. The first gradient then
    misses a band's splats, which ``grad_gap`` sees."""
    import rtgs_tpu_torch.ops.peel as peel

    calls = []
    orig = peel.PeelFused.backward

    def zero_one_band(ctx, *grads):
        out = orig(ctx, *grads)
        calls.append(1)
        if len(calls) % 4 == 1:
            out = (torch.zeros_like(out[0]),) + tuple(out[1:])
        return out

    monkeypatch.setattr(peel.PeelFused, "backward",
                        staticmethod(zero_one_band))
    out = H.run_cell(tiny(), 12, 0.5, False, "cpu")
    assert len(calls) >= 4 * 3
    gap = out["checks"]["grad_gap"]
    assert not out["correct"] and gap["value"] > gap["limit"], out["checks"]
