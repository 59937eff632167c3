"""The port's structured scene (rtgs_tpu_torch.probes.make_scene) against
the JAX package's script (scripts/make_scene.py), left as it is.

Importing the script would call ``force_cpu_devices(1)`` and reset JAX's
backends for the whole test process, so its ``structured_scene`` is read
out of the source and run in a namespace of its own imports. Both draw from
``np.random.default_rng(seed)`` in the same order and cast to float32
once: the arrays must be bitwise equal. The ``.ply`` the port's CLI writes
reloads through both packages' loaders, each applying the activations to
the same stored values: equal to each other bitwise and to the scene to
float32 rounding of log/exp and logit/sigmoid (rtol 1e-6, atol 1e-7).

``candidate_counts``: at its least budgets the binning drops nothing, and
one below either of them it drops a pair.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtgs_tpu.gaussians import Gaussians as JGaussians
from rtgs_tpu.scene import load_scene as j_load_scene
from rtgs_tpu_torch.probes import _common, make_scene
from rtgs_tpu_torch.render.binning import tile_candidates
from rtgs_tpu_torch.scene import load_scene

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = ("means", "quats", "scales", "colors", "opacities", "sh", "mask")


@pytest.fixture(scope="module")
def script_scene():
    """``structured_scene`` of scripts/make_scene.py, without the script's
    module-level side effects."""
    path = ROOT / "scripts" / "make_scene.py"
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "structured_scene")
    ns = {"np": np, "jnp": jnp, "Gaussians": JGaussians}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"),
         ns)
    return ns["structured_scene"]


@pytest.mark.parametrize("n,seed", [(4000, 0), (1001, 5)])
def test_structured_scene_is_the_scripts(script_scene, n, seed):
    ref = script_scene(n, seed)
    got = make_scene.structured_scene(n, seed, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert got.num == n


def test_ply_reloads_through_both_loaders(tmp_path, capsys):
    path = tmp_path / "structured.ply"
    make_scene.main([str(path), "4000", "--device", "cpu"])
    assert f"wrote 4000 splats -> {path}" in capsys.readouterr().out
    arrays = make_scene.structured_scene_arrays(4000)
    got = load_scene(path, device="cpu")
    ref = j_load_scene(path)
    for f in FIELDS:
        a = getattr(got, f).numpy()
        np.testing.assert_array_equal(a, np.asarray(getattr(ref, f)),
                                      err_msg=f)
        np.testing.assert_allclose(a, arrays[f], rtol=1e-6, atol=1e-7,
                                   err_msg=f)


def test_candidate_counts_are_the_least_clean_budgets():
    g = make_scene.structured_scene(6000, device="cpu")
    cam = _common.bench_camera((96, 64), torch.device("cpu"))
    counts = make_scene.candidate_counts(g, cam)
    least_c, least_g = counts["least_candidates"], counts["least_global"]
    assert least_c > 0 and least_g > 0
    assert counts["slots"].max() == least_c + least_g

    def dropped(c, glob):
        b = tile_candidates(g, cam, max_candidates=c, max_global=glob)
        return int(b.local_overflow), int(b.global_overflow)

    assert dropped(least_c, least_g) == (0, 0)
    assert dropped(least_c - 1, least_g)[0] > 0
    assert dropped(least_c, least_g - 1)[1] > 0
    summary = make_scene.count_summary(counts)
    assert summary["tiles"] == 24 and summary["max_slots"] == \
        least_c + least_g
