"""The port's scene I/O (its own numpy PLY/splt readers and the activation
contract) against rtgs_tpu.scene, and its save/load round trips."""

import pathlib

import numpy as np
import pytest
import torch

from rtgs_tpu.scene import load_scene as j_load_scene
from rtgs_tpu_torch import gaussians as TG
from rtgs_tpu_torch.io.ply import read_ply, write_ply
from rtgs_tpu_torch.scene import (inverse_sigmoid, load_scene, random_scene,
                                  save_scene, sigmoid)

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


@pytest.mark.parametrize("layout", ["inria", "reference_flat"])
@pytest.mark.parametrize("name", ["ref_test.ply", "synthetic120.ply"])
def test_load_matches_jax_exactly(name, layout):
    t = load_scene(GOLDEN / name, sh_layout=layout, device="cpu")
    j = j_load_scene(GOLDEN / name, sh_layout=layout)
    for f in TG.FIELDS:
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert a.dtype == np.float32 and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_unknown_layout_raises():
    with pytest.raises(ValueError, match="sh_layout"):
        load_scene(GOLDEN / "ref_test.ply", sh_layout="bogus", device="cpu")


@pytest.mark.parametrize("fmt", ["binary_little_endian", "ascii"])
def test_ply_roundtrip(tmp_path, fmt):
    rng = np.random.default_rng(0)
    cols = {"x": rng.random(7).astype(np.float32),
            "n": np.arange(7, dtype=np.int32)}
    write_ply(tmp_path / "c.ply", cols, fmt=fmt)
    back = read_ply(tmp_path / "c.ply")
    assert list(back) == list(cols)
    for k in cols:
        np.testing.assert_allclose(back[k], cols[k], rtol=1e-6)


@pytest.mark.parametrize("layout", ["inria", "reference_flat"])
def test_save_load_roundtrip(tmp_path, layout):
    g = random_scene(50, extent=0.5, seed=4, device="cpu")
    path = tmp_path / "s.ply"
    save_scene(path, g, sh_layout=layout)
    g2 = load_scene(path, sh_layout=layout, device="cpu")
    # The JAX package reads the port's file the same way.
    j = j_load_scene(path, sh_layout=layout)
    for f in TG.FIELDS:
        np.testing.assert_array_equal(getattr(g2, f).numpy(),
                                      np.asarray(getattr(j, f)))
    torch.testing.assert_close(g2.means, g.means, rtol=1e-5, atol=0)
    torch.testing.assert_close(g2.scales, g.scales, rtol=1e-4, atol=0)
    torch.testing.assert_close(g2.colors, g.colors, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(g2.opacities, g.opacities, rtol=1e-4, atol=0)
    torch.testing.assert_close(g2.sh, g.sh, rtol=1e-4, atol=1e-6)
    # q and −q are the same rotation.
    sign = torch.sign((g2.quats * g.quats).sum(-1, keepdim=True))
    torch.testing.assert_close(g2.quats * sign, g.quats, rtol=0, atol=1e-5)


def test_save_drops_masked(tmp_path):
    g = random_scene(10, seed=5, device="cpu")
    g.mask[3:] = 0.0
    save_scene(tmp_path / "m.ply", g)
    assert load_scene(tmp_path / "m.ply", device="cpu").num == 3


def test_splt_roundtrip(tmp_path):
    g = random_scene(40, extent=0.5, seed=6, device="cpu")
    p = tmp_path / "s.splt"
    save_scene(p, g)
    assert p.stat().st_size == 40 * 32
    g2 = load_scene(p, device="cpu")
    j = j_load_scene(p)
    for f in TG.FIELDS:
        np.testing.assert_array_equal(getattr(g2, f).numpy(),
                                      np.asarray(getattr(j, f)))
    torch.testing.assert_close(g2.means, g.means, rtol=1e-6, atol=0)
    assert torch.count_nonzero(g2.sh) == 0


def test_sigmoid_inverse():
    x = np.linspace(-8, 8, 33)
    np.testing.assert_allclose(inverse_sigmoid(sigmoid(x)), x, rtol=1e-9)


def test_random_scene_is_seeded():
    a = random_scene(20, seed=9, device="cpu")
    b = random_scene(20, seed=9, device="cpu")
    assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in TG.FIELDS)
    c = random_scene(20, seed=10, device="cpu")
    assert not torch.equal(a.means, c.means)
    assert a.means.abs().max() <= 1.0 and a.opacities.min() >= 0.2
