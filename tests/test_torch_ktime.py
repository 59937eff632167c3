"""The timing probe's host side (rtgs_tpu_torch.probes.ktime), the
anisotropic scene it and the card's checks use, and the table scatter of
the plain backward twins, on the CPU. The kernels themselves run only on
the card (tests/test_torch_*_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from rtgs_tpu_torch.ops import _build
from rtgs_tpu_torch.ops import peel
from rtgs_tpu_torch.probes import ktime
from rtgs_tpu_torch.scene import anisotropic_scene


@pytest.fixture
def build_paths():
    """Restore the source and build directories of ``ops/_build``."""
    saved = _build.SRC_DIR, _build.BUILD_DIR
    yield saved
    _build.SRC_DIR, _build.BUILD_DIR = saved


def test_edited_sources_apply_to_a_copy(tmp_path, build_paths):
    src, _ = build_paths
    before = {p.name: p.read_bytes() for p in src.glob("*.cu*")}
    ktime.edited_sources(
        ["peel_common.cuh::constexpr int kBatch::constexpr int kBatchEdited"],
        tmp_path)
    assert _build.SRC_DIR == tmp_path / "csrc"
    assert _build.BUILD_DIR == tmp_path / "build"
    edited = (_build.SRC_DIR / "peel_common.cuh").read_text()
    assert "kBatchEdited" in edited
    # Every source is there, the others unchanged, the repository's untouched.
    for name, data in before.items():
        assert (src / name).read_bytes() == data
        if name != "peel_common.cuh":
            assert (_build.SRC_DIR / name).read_bytes() == data
    # The library's name follows the edited sources.
    edited_lib = _build.library_path()
    _build.SRC_DIR = src
    assert _build.library_path().name != edited_lib.name


def test_edited_sources_refuse_text_that_is_not_there(tmp_path,
                                                      build_paths):
    with pytest.raises(ValueError, match="does not occur"):
        ktime.edited_sources(["keys.cu::no such text::x"], tmp_path)


@pytest.mark.parametrize("key", sorted(ktime.SHAPES))
def test_shapes_are_the_benchmarks(key):
    label, n, w, h, cand, narrow = ktime.SHAPES[key]
    assert label == f"{n // 1000 if n < 10**6 else n // 10**6}" \
        f"{'k' if n < 10**6 else 'M'}@{w}x{h}"
    assert cand % peel.CHUNK == 0 and w % 16 == 0 and h % 16 == 0
    assert narrow is None or narrow > 0


def test_table_grad_scatters_per_slot_rows():
    """A (T, C, 64) block is scattered like PeelFused.backward's plain
    path; an (N+1, 64) table is passed through."""
    rng = np.random.default_rng(0)
    n, t, c = 40, 3, 128
    packed = torch.zeros((n + 1, peel.F_DIM))
    cand = torch.from_numpy(rng.integers(-1, n, (t, c)).astype(np.int32))
    dfeats = torch.from_numpy(
        rng.standard_normal((t, c, peel.F_DIM)).astype(np.float32))
    dfeats[cand < 0] = 0.0
    table = ktime.table_grad(packed, cand, dfeats)
    assert table.shape == packed.shape and (table[n] == 0).all()
    want = np.zeros((n + 1, peel.F_DIM), np.float64)
    np.add.at(want, np.where(cand.numpy() >= 0, cand.numpy(), n).reshape(-1),
              dfeats.numpy().reshape(-1, peel.F_DIM).astype(np.float64))
    np.testing.assert_allclose(table.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(table, peel._scatter_slot_grads(packed, cand, dfeats))
    assert ktime.table_grad(packed, cand, table) is table


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_anisotropic_scene_ratios(seed):
    g = anisotropic_scene(500, extent=0.5, seed=seed)
    ratio = g.scales.amax(-1) / g.scales.amin(-1)
    assert float(ratio.min()) >= 100.0 * (1 - 1e-5)
    assert float(ratio.max()) <= 1000.0 * (1 + 1e-5)
    assert float(g.scales.amin()) >= 1e-4 * (1 - 1e-5)
    assert float(g.means.abs().max()) <= 0.5
    again = anisotropic_scene(500, extent=0.5, seed=seed)
    assert torch.equal(again.scales, g.scales)
    assert torch.equal(again.means, g.means)


def test_ktime_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ktime.main(["--iters", "1"])
