"""The port's recovery protocol (rtgs_tpu_torch.probes.fitbench) against the
JAX package's script (scripts/fitbench.py), loaded by path and left as it
is, on the same inputs at a tiny size: a 1,000-splat bench scene
(``random_scene``: extent 2.0, scales 0.005-0.03) made with numpy and
bridged into the script in place of its ``jax.random`` scene, 4 views at
32x24, depth 8, 12 steps, both through the oracle (what ``auto`` picks at
1,000 splats; the two packages' ``tiled`` paths differ on small splats,
tests/test_torch_fitscratch.py).

The script draws its noise from ``jax.random``; here both sides draw it
from the port's ``torch.Generator`` (``fitbench.noise``), fed to the script
through ``jax.random.normal``. Every step's PSNR agrees to 0.05 dB and the
curve's losses to 1e-3 (Adam and the loss in another framework's f32
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtgs_tpu_torch.bridge import gaussians_from_numpy
from rtgs_tpu_torch.probes import fitbench
from rtgs_tpu_torch.scene import random_scene_arrays
from rtgs_tpu_torch.train.solver import init_params
from _torch_scripts import run_script

GT_N, VIEWS, RES, DEPTH, CAND, STEPS = 1000, 4, (32, 24), 8, 2048, 12
PSNR_TOL = 0.05


@pytest.fixture(scope="module")
def runs():
    """(script result, its steps, port result) of one run each."""
    fields = random_scene_arrays(GT_N, 2.0, (0.005, 0.03), seed=0)
    gt = gaussians_from_numpy(fields, device="cpu")
    z = fitbench.noise(init_params(gt))
    draws = [jnp.asarray(z[f].numpy()) for f, _ in fitbench.NOISE]

    def from_port(key, shape=(), dtype=jnp.float32):
        d = draws.pop(0)
        assert d.shape == tuple(shape)
        return d.astype(dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", from_port)
        ref, ref_steps = run_script("fitbench", [
            str(GT_N), "--steps", str(STEPS), "--views", str(VIEWS),
            "--res", f"{RES[0]},{RES[1]}", "--depth", str(DEPTH),
            "--cand", str(CAND), "--renderer", "oracle"], fields, mp)
    assert not draws
    got = fitbench.run(gt, steps=STEPS, views=VIEWS, res=RES, depth=DEPTH,
                       cand=CAND, renderer="oracle", log=lambda m: None)
    return ref, ref_steps, got


def test_fitbench_matches_script(runs):
    ref, ref_steps, got = runs
    assert [c["step"] for c in got["curve"]] == \
        [c["step"] for c in ref["curve"]] == [0, STEPS - 1]
    np.testing.assert_allclose(got["psnrs"], [p for p, _ in ref_steps],
                               atol=PSNR_TOL)
    for c, cj in zip(got["curve"], ref["curve"]):
        assert abs(c["loss"] - cj["loss"]) < 1e-3
    assert got["n"] == ref["n"] == GT_N and got["peak_gib"] is None


def test_fitbench_recovers(runs):
    """PSNR over the last round of views above the first round's, on both
    sides: the perturbed scene moves back toward its own renders."""
    ref, ref_steps, got = runs
    first_j = np.mean([p for p, _ in ref_steps[:VIEWS]])
    last_j = np.mean([p for p, _ in ref_steps[-VIEWS:]])
    assert got["last_psnr"] > got["first_psnr"] and last_j > first_j
