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
    """A plain twin's (T, C, 64) per-slot block becomes the (N+1, 64) table
    as PeelFused.backward's plain path makes it (``_scatter_slot_grads``):
    the rows summed by splat in (tile, slot) order by ``segment_rows``, the
    padding's zeros into the sentinel row."""
    rng = np.random.default_rng(0)
    n, t, c = 40, 3, 128
    packed = torch.zeros((n + 1, peel.F_DIM))
    cand = torch.from_numpy(rng.integers(-1, n, (t, c)).astype(np.int32))
    dfeats = torch.from_numpy(
        rng.standard_normal((t, c, peel.F_DIM)).astype(np.float32))
    dfeats[cand < 0] = 0.0
    table = peel._scatter_slot_grads(packed, cand, dfeats)
    assert table.shape == packed.shape and (table[n] == 0).all()
    want = np.zeros((n + 1, peel.F_DIM), np.float64)
    np.add.at(want, np.where(cand.numpy() >= 0, cand.numpy(), n).reshape(-1),
              dfeats.numpy().reshape(-1, peel.F_DIM).astype(np.float64))
    np.testing.assert_allclose(table.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(table, peel.segment_rows(
        dfeats.reshape(-1, peel.F_DIM), cand.reshape(-1), n + 1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_anisotropic_scene_ratios(seed):
    g = anisotropic_scene(500, extent=0.5, seed=seed, device="cpu")
    ratio = g.scales.amax(-1) / g.scales.amin(-1)
    assert float(ratio.min()) >= 100.0 * (1 - 1e-5)
    assert float(ratio.max()) <= 1000.0 * (1 + 1e-5)
    assert float(g.scales.amin()) >= 1e-4 * (1 - 1e-5)
    assert float(g.means.abs().max()) <= 0.5
    again = anisotropic_scene(500, extent=0.5, seed=seed, device="cpu")
    assert torch.equal(again.scales, g.scales)
    assert torch.equal(again.means, g.means)


def test_ktime_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ktime.main(["--iters", "1"])


@pytest.mark.parametrize("name, want", [
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<at_cuda_detail"
     "::cub::Policy<int>, false>(int*, int*)", "DeviceRadixSortOnesweepKernel"),
    ("(anonymous namespace)::place_kernel(float const*, int)", "place_kernel"),
    ("Memset (Device)", "Memset"),
    ("at::native::(anonymous namespace)::fill_reverse_indices_kernel(long*)",
     "fill_reverse_indices_kernel"),
])
def test_kernel_names_are_shortened(name, want):
    assert ktime.short_name(name) == want


def test_run_lengths_of_ids():
    """The share of rows an id names and the run statistics, against
    numpy; ids outside [0, n_out) are not counted."""
    rng = np.random.default_rng(3)
    ids = rng.integers(-1, 60, 5000)
    ids[:400] = 7                                   # one long run
    got = ktime.run_lengths(torch.from_numpy(ids.astype(np.int32)), 50)
    runs = np.bincount(ids[(ids >= 0) & (ids < 50)], minlength=50)
    named = runs[runs > 0]
    assert got["named"] == named.size / 50
    assert got["median"] == np.median(named)
    assert got["longest"] == named.max() and got["over32"] == (named > 32).sum()
    assert abs(got["p99"] - np.quantile(named, 0.99)) < 1e-9
    empty = ktime.run_lengths(torch.full((4,), -1, dtype=torch.int32), 3)
    assert empty["named"] == 0.0 and empty["longest"] == 0


def test_segment_bound_counts_rows_ids_and_table():
    """(M + n_out) rows of 256 bytes and M ids of 4, over 3.35 TB/s."""
    assert ktime.segment_bound_ms(216_135, 100_001) == pytest.approx(
        ((216_135 + 100_001) * 256 + 4 * 216_135) / 3.35e12 * 1e3)
