"""The port's from-scratch protocol (rtgs_tpu_torch.probes.fitscratch)
against the JAX package's script (scripts/fitscratch.py), loaded by path
and left as it is, on the same inputs at a tiny size: a 1,000-splat
``structured_scene`` (a plane, clusters and a shell) made with numpy and
bridged into the script in place of its ``jax.random`` scene, 500 seeds, 4
views at 32x24, depth 8, 13 steps with a density pass every 5. The script
runs once, in a module fixture, and each test reads that run. Both sides
render through the oracle (1,000 splats: what ``auto`` picks), where the
two packages agree to ~1e-6: their ``tiled`` paths differ by up to 0.15 on
small splats (the JAX path's f32 entry depth misses grazing hits the
port's float64 one finds).

The scripts settle their last 200 steps without density control; here
both settle 3 (the script's ``TrainConfig`` is wrapped to move
``densify_until`` by the same 197 steps, the port's ``SETTLE`` is set to
3), so the passes fall at steps 5 and 10. The growth events (step, old,
new) must be equal. Tolerances: the oracles agree to ~1e-6 but Adam and
the loss run in another framework's f32 order, so every step's PSNR agrees
to 0.05 dB and the live count to 1% (a clone decision on the gradient
threshold may flip on an ulp). With ``--max-live`` reached at the first
pass, the script's mutation of ``cfg.densify_until`` stops density control
on both sides: the pass at step 10 never runs.

On the uniform box the script's code draws, nothing survives the first
density pass to grow, in either package (fault F11): the seeds' isotropic
scale exceeds the world-size prune, which both packages' solvers apply to
the same seeded parameters.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import rtgs_tpu.config as jconfig
from rtgs_tpu.train import solver as jsolver
from rtgs_tpu_torch.bridge import gaussians_from_numpy
from rtgs_tpu_torch.config import TrainConfig
from rtgs_tpu_torch.probes import fitscratch
from rtgs_tpu_torch.probes.make_scene import structured_scene_arrays
from rtgs_tpu_torch.scene import random_scene_arrays
from rtgs_tpu_torch.train.solver import Solver, training_renderer
from _torch_scripts import run_script

GT_N, VIEWS, RES, DEPTH, CAND = 1000, 4, (32, 24), 8, 2048
SEEDS, STEPS, EVERY, SETTLE, THRESHOLD, MAX_LIVE = 500, 13, 5, 3, 2e-5, 700
PSNR_TOL, LIVE_RTOL = 0.05, 0.01


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(script result, its steps, port result, its steps) of one run each
    on the structured scene, steps as (PSNR, live count)."""
    tmp = tmp_path_factory.mktemp("fitscratch")
    fields = structured_scene_arrays(GT_N, seed=0)
    config = jconfig.TrainConfig
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconfig, "TrainConfig", lambda **kw: config(**dict(
            kw, densify_until=kw["densify_until"] + 200 - SETTLE)))
        ref, ref_steps = run_script("fitscratch", [
            "--gt-n", str(GT_N), "--seed-points", str(SEEDS),
            "--steps", str(STEPS), "--views", str(VIEWS),
            "--res", f"{RES[0]},{RES[1]}", "--depth", str(DEPTH),
            "--cand", str(CAND), "--renderer", "oracle",
            "--densify-every", str(EVERY),
            "--densify-grad-threshold", str(THRESHOLD),
            "--max-live", str(MAX_LIVE), "--out", str(tmp / "jax.ply")],
            fields, mp)
    steps = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fitscratch, "SETTLE", SETTLE)
        got = fitscratch.run(
            gaussians_from_numpy(fields, device="cpu"), seed_points=SEEDS,
            steps=STEPS, views=VIEWS, res=RES, depth=DEPTH, cand=CAND,
            renderer="oracle", densify_every=EVERY, threshold=THRESHOLD,
            max_live=MAX_LIVE, out=str(tmp / "torch.ply"),
            count_dropped=True,
            on_step=lambda s, m: steps.append((m["psnr"], s.num_live)),
            log=lambda m: None)
    return ref, ref_steps, got, steps


def test_fitscratch_matches_script(runs):
    ref, ref_steps, got, steps = runs
    assert len(steps) == len(ref_steps) == STEPS
    for (p, live), (pj, live_j) in zip(steps, ref_steps):
        assert abs(p - pj) < PSNR_TOL
        assert abs(live - live_j) <= LIVE_RTOL * live_j
    # One growth, at the first density pass.
    assert [tuple(e) for e in ref["capacity_growths"]] == \
        got["capacity_growths"] == [(EVERY, 512, 1024)]
    assert got["capacities"] == ref["recompiles"] == 2
    assert abs(got["final_live"] - ref["final_live"]) <= \
        LIVE_RTOL * ref["final_live"]
    assert [s for s, _, _ in got["psnr_curve"]] == \
        [s for s, _, _ in ref["psnr_curve"]] == [1]
    for (_, p, _), (_, pj, _) in zip(got["psnr_curve"], ref["psnr_curve"]):
        assert abs(p - pj) < PSNR_TOL + 0.01


def test_max_live_stops_density_control(runs):
    """The live count passes --max-live at the first pass; the loop then
    sets ``cfg.densify_until`` to 0, which the solver reads on every step,
    so the pass due at step 10 never runs, on either side."""
    _, ref_steps, got, steps = runs
    for s in (steps, ref_steps):
        assert s[EVERY - 2][1] == SEEDS and s[EVERY - 1][1] >= MAX_LIVE
        assert len({live for _, live in s[EVERY - 1:]}) == 1
    assert got["solver"].cfg.densify_until == 0


def test_fitscratch_round_trip_and_budgets(runs):
    _, _, got, steps = runs
    assert got["final_live"] == got["reloaded"] == steps[-1][1]
    assert got["dropped_pairs"] == 0
    # Both resolve the step's renderer by capacity, which pruning never
    # lowers: auto would stay off the oracle once capacity passes 4096.
    solver = got["solver"]
    assert solver.scene().num == solver.mask.shape[0] == 1024
    assert training_renderer("auto", 4097, "cpu") == "tiled"


def test_fitscratch_on_a_box_collapses_in_both():
    """Fault F11, the reference's own: on the uniform box the script's code
    fits, the seeds' isotropic scale (the median nearest-neighbour distance
    of 512 seeds) exceeds the world-size prune (0.1 of the 90th percentile
    of |mean|), so a density pass on the seeded parameters prunes every
    seed, in the JAX solver as in the port's; nothing is left to grow."""
    fields = random_scene_arrays(2000, 2.0, (0.005, 0.03), seed=0)
    params, mask = fitscratch.seed_params(
        gaussians_from_numpy(fields, device="cpu"), 1000)
    cfg = TrainConfig(densify_grad_threshold=THRESHOLD)
    port = Solver(params=params, mask=mask, cfg=cfg, cameras=[], targets=[])
    ref = jsolver.Solver(
        params=jsolver.SceneParams(*(jnp.asarray(x.numpy())
                                     for x in params)),
        mask=jnp.asarray(mask.numpy()),
        cfg=jconfig.TrainConfig(densify_grad_threshold=THRESHOLD),
        cameras=[], targets=[])
    assert port.scene_extent == pytest.approx(ref.scene_extent, rel=1e-6)
    seed_scale = float(params.log_scales[0, 0].exp())
    assert seed_scale > 0.1 * port.scene_extent
    port.densify_and_prune()
    ref.densify_and_prune()
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
    assert port.num_live == ref.num_live == 0
    assert port.mask.shape[0] == ref.mask.shape[0] == 1024
