"""Tiny rehearsals on the CPU: each traffic kind runs through the harness
(without its look for a card) and the reference finds the program correct;
the control reads above each cell's limit; and every fault a cell can have,
planted under the timed path, makes ``correct`` false.

The sizes are cut for a test run (6,000 splats, more than the oracle's
4,096; 96×64 frames, depth at most 80, pose 0 alone checked (a frame takes
about a second here); 3 views of 64×48 for the fit; the render control at 40,000 splats
and 128×96), and ``auto`` is named ``pallas``, the path it takes on the card
(the port's plain twins run it here). The cells' limits are the real cells'."""

import pytest
import torch

from benchmark import control as C
from benchmark import run as H


def tiny(name: str, n: int = 6000, res=(96, 64)) -> dict:
    cell = H.load_cell(name)
    cfg, mix = cell["config_data"], cell["mix"]
    cfg["scene"]["n"] = n
    if mix["renderer"] == "auto":
        mix["renderer"] = "pallas"
    if mix["kind"] == "orbit_render":
        cfg["camera"]["res"] = list(res)
        cfg["render"].update(tile_bands=2, max_candidates=2048)
        mix.update(depth=min(mix["depth"], 80), warmup_frames=1,
                   check_frames=1, check_within=2)
    else:
        cfg["camera"]["res"] = [64, 48]
        cfg["render"].update(max_candidates=2048, max_global=2048)
        mix.update(views=3, warmup_steps=3)
    return cell


def dense(name: str) -> dict:
    """A tiny render cell whose pixels meet more layers than the depth
    (up to 80) holds: 4,500 splats of scales 0.1-0.2 at 64×48."""
    cell = tiny(name, n=4500, res=(64, 48))
    cell["config_data"]["scene"]["scale_range"] = [0.1, 0.2]
    cell["config_data"]["render"].update(max_candidates=4608,
                                         max_global=4608)
    return cell


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


RENDER = ["render1m_orbit_d16", "render1m_keys_d16", "render1m_orbit_d128"]


@pytest.mark.parametrize("name", RENDER + ["fit100k_refit"])
def test_cell_rehearsal_is_correct(name):
    out = H.run_cell(tiny(name), 2**31 + 7, 0.5, False, "cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    names = {m["name"] for m in tiny(name)["end_to_end"]}
    assert set(out["metrics"]) == names
    assert all(v["value"] > 0 for v in out["metrics"].values())


@pytest.mark.parametrize("name", ["render1m_orbit_d16", "fit100k_refit"])
def test_control_fails(name):
    # A frame of 6,000 splats is mostly background, where the control is
    # right: 40,000 fill it as the cell's 1M fill 1920x1088.
    cell = tiny(name, n=40_000, res=(128, 96))
    vals = C.reading(cell, 11, "control", 0.5, "cpu")
    assert any(v > cell["checks"][k] for k, v in vals.items()
               if k in cell["checks"]), vals


@pytest.mark.parametrize("name", RENDER)
def test_dense_frame_is_correct_and_half_depth_fails(name):
    """Where pixels meet more layers than the depth, the sound frame counts
    the reference's, and one that composites half of them fails on
    ``winners_gap``, which the image alone barely sees."""
    out = H.run_cell(dense(name), 21, 0.5, False, "cpu")
    assert out["correct"], out["checks"]
    with C.planted("half_depth"):
        out = H.run_cell(dense(name), 21, 0.5, False, "cpu")
    gap = out["checks"]["winners_gap"]
    assert not out["correct"] and gap["value"] > gap["limit"], out["checks"]


@pytest.mark.parametrize("name,fault", [
    ("render1m_orbit_d16", "altered"), ("render1m_keys_d16", "altered"),
    ("fit100k_refit", "half_batch"), ("fit100k_refit", "unchanged")])
def test_fault_fails(name, fault):
    cell = tiny(name)
    with C.planted(fault):
        out = H.run_cell(cell, 12, 0.5, False, "cpu")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("seed", [1607684347, 2**31 + 7, 3999999937])
def test_refit_start_within_scene_law(seed):
    """The perturbed start's scales stay in the configuration's range, so
    every seed's flattest splat is the law's, and the means and color
    logits are perturbed as the mix says."""
    import math

    from benchmark import scene as S

    cell = tiny("fit100k_refit", n=20_000)
    w = H.workload(cell, seed, "cpu")
    w.fields = S.uniform_scene(cell["config_data"], seed, "cpu")
    raw = w.raw_start()
    lo, hi = cell["config_data"]["scene"]["scale_range"]
    s = torch.exp(raw["log_scales"])
    assert s.min() >= lo * (1 - 1e-6) and s.max() <= hi * (1 + 1e-6)
    assert (s.max(-1).values / s.min(-1).values).max() <= hi / lo * (1 + 1e-5)
    # The clamp binds on a share of the axes, and moves nothing else.
    at_edge = ((raw["log_scales"] <= math.log(lo) + 1e-6)
               | (raw["log_scales"] >= math.log(hi) - 1e-6)).float().mean()
    assert 0.02 < float(at_edge) < 0.3
    dm = (raw["means"] - w.fields["means"]).std()
    assert abs(float(dm) / cell["mix"]["noise"]["means"] - 1) < 0.05
