"""The port's image-quality probe (rtgs_tpu_torch.probes.imquality) against
the JAX package's script (scripts/imquality.py), loaded by path and left as
it is, on the same inputs.

``metrics``: the script's function on the same numpy images. Mean and p99
|diff| are numpy in both, so equal; PSNR and SSIM are f32 means in another
framework, rounded to 2 and 5 digits as the script rounds them, so they
agree to one unit of the last digit. Identical images read 120.0 dB.

``run_config``: a 4,097-splat configuration at 64x48 (12 tiles), the
scene made with numpy and bridged into the script in place of its
``jax.random`` scene, ``bench.CONFIGS`` replaced by this one
configuration; each side runs once, in a module fixture, which keeps the
images each side's ``metrics`` is given. 4,097 is the least count at which
``auto`` leaves the oracle (it resolves to ``tiled`` on the CPU), so the
auto row is not the oracle against itself. The splats are the oracle
fixture's (half-size 1.5, scales 0.05-0.2): with the bench scene's tiny
splats the script's f32 entry depth misses grazing hits that the port's
float64 one finds (tests/test_torch_probes.py). On the CPU the script's
production render is its XLA keys twin, and the port's the plain keys
selection, so both production rows read 120.0 dB against their twins.

The images are held against the script's directly. The two packages'
oracles agree to 1e-3 on all but at most 2 of the 3,072 pixels: near-tied
depths, which the port's float64 t1 orders otherwise than the reference's
f32 chain (ROADMAP.md §3). On every other pixel the port's keys images
(production and twin) agree with the script's to 1e-3: the two keys paths
differ only by f32 shading (each lies within 1.5e-3 of its own oracle),
and their mean |diff| is under 5e-5. Against the oracle both keys rows
read above 80 dB and SSIM 1.0; the auto row (``tiled``) reaches the floors
``chip_smoke.py`` phase 21 holds on the card, 40 dB and 0.999.
"""

import numpy as np
import pytest

import bench
import rtgs_tpu.scene as jscene
from rtgs_tpu_torch.bridge import gaussians_from_numpy
from rtgs_tpu_torch.probes import imquality
from rtgs_tpu_torch.render.api import resolve_renderer
from rtgs_tpu_torch.scene import random_scene_arrays
from _torch_scripts import jax_scene, load_script

CFG = dict(n=4097, res=(64, 48), label="4k@64x48", max_candidates=4096,
           bin_narrow=4, tile_bands=None)


@pytest.fixture(scope="module")
def script():
    return load_script("imquality")


def keeping(metrics, calls):
    """``metrics`` that also keeps the two images it is given (numpy)."""
    def kept(a, b):
        calls.append((np.asarray(a), np.asarray(b)))
        return metrics(a, b)
    return kept


def row_images(calls):
    """(production, twin, oracle) from a row's three ``metrics`` calls:
    (production, twin), (production, oracle), (twin, oracle)."""
    return calls[0][0], calls[0][1], calls[1][1]


@pytest.fixture(scope="module")
def runs(script):
    """(script row, its images, port result, its images by row) of one
    ``run_config`` each; images as :func:`row_images`."""
    fields = random_scene_arrays(CFG["n"], 1.5, (0.05, 0.2), seed=0)
    ref_calls, calls = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jscene, "random_scene",
                   lambda key, n, **kw: jax_scene(fields))
        mp.setattr(bench, "CONFIGS", [dict(
            n=CFG["n"], res=CFG["res"], depth=16, label=CFG["label"],
            render_kw=dict(max_candidates=CFG["max_candidates"],
                           bin_narrow=CFG["bin_narrow"]))])
        mp.setattr(script, "metrics", keeping(script.metrics, ref_calls))
        ref = script.run_config(0)
        mp.setattr(imquality, "metrics", keeping(imquality.metrics, calls))
        got = imquality.run_config(
            CFG, imquality._common.device_of("cpu"),
            g=gaussians_from_numpy(fields, device="cpu"),
            log=lambda m: None)
    return ref, row_images(ref_calls), got, {
        "keys": row_images(calls[:3]), "auto": row_images(calls[3:])}


@pytest.mark.parametrize("pair", ["identical", "different"])
def test_metrics_match_script(script, pair):
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (40, 30, 3)).astype(np.float32)
    b = a if pair == "identical" else np.clip(
        a + 0.05 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    got, ref = imquality.metrics(a, b), script.metrics(a, b)
    if pair == "identical":
        assert got["psnr_db"] == ref["psnr_db"] == 120.0
        assert got["ssim"] == ref["ssim"] == 1.0
    assert abs(got["psnr_db"] - ref["psnr_db"]) <= 0.01
    assert abs(got["ssim"] - ref["ssim"]) <= 1e-5
    assert got["mean_absdiff"] == ref["mean_absdiff"]
    assert got["p99_absdiff"] == ref["p99_absdiff"]


def test_run_config_matches_script(runs):
    ref, ref_images, got, images = runs
    keys = got["rows"][0]
    assert got["oracle"] and keys["row"] == "keys"
    assert ref["prod_vs_twin"]["psnr_db"] == 120.0
    assert keys["prod_vs_twin"]["psnr_db"] == 120.0
    assert keys["prod_vs_twin"]["max_absdiff"] == 0.0
    oracle, ref_oracle = images["keys"][2], ref_images[2]
    tie = np.abs(oracle - ref_oracle).max(-1) > 1e-3
    assert tie.sum() <= 2
    for mine, theirs in zip(images["keys"][:2], ref_images[:2]):
        np.testing.assert_allclose(mine[~tie], theirs[~tie], rtol=0,
                                   atol=1e-3)
        assert np.abs(mine - theirs).mean() < 5e-5
    for pair in ("prod_vs_oracle", "twin_vs_oracle"):
        m, mj = keys[pair], ref[pair]
        assert 80.0 < m["psnr_db"] < 120.0 and 80.0 < mj["psnr_db"] < 120.0
        assert m["ssim"] == mj["ssim"] == 1.0


def test_auto_row_leaves_the_oracle(runs):
    _, _, got, images = runs
    auto = got["rows"][1]
    assert resolve_renderer("auto", CFG["n"] - 1, "cpu") == "oracle"
    assert auto["row"] == "auto" and auto["renderer"] == "tiled"
    assert auto["prod_vs_twin"]["max_absdiff"] == 0.0
    m = auto["prod_vs_oracle"]
    assert 40.0 <= m["psnr_db"] < 120.0 and m["ssim"] >= 0.999
    assert m["max_absdiff"] > 0.0
    np.testing.assert_array_equal(images["auto"][2], images["keys"][2])
