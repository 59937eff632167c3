"""Bitwise repeatability of the port's backward passes, as the JAX package
promises for its pipeline (tests/test_tiled.py::test_bitwise_determinism),
and the two-stage reduction that gives it (rtgs_tpu_torch.ops.peel):
stage 1 sums each (tile, slot) pair's gradient row over the tile's pixels in
a fixed order, stage 2 (``segment_rows``: ``csrc/segment_rows.cu`` on the
card, ``index_add_`` on the CPU) sums each splat's rows in row order.

The module imports no JAX at its top, so that its ``cuda``-marked tests run
where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_determinism.py

The tests against the JAX package (``jax.ops.segment_sum``, the VJPs of
``peel_pallas``, ``peel_topk_pallas`` and ``shade_winners_kp``, Pallas in
interpret mode on the CPU) import it inside, and hold the port at the
tolerances the existing tests state: tests/test_torch_peel_fused.py (q99
1e-3, max 0.2 of the largest entry), tests/test_torch_peel_topk.py (max
2e-3, q99 2e-4) and tests/test_torch_keys_grad.py (1e-5 relative plus 1e-6
of the lane's largest entry). Repeat runs are compared with
``torch.equal``: bitwise, not allclose."""

import dataclasses

import numpy as np
import pytest
import torch

from rtgs_tpu_torch.camera import camera_from_fov
from rtgs_tpu_torch.ops import peel as T_PEEL
from rtgs_tpu_torch.ops.peel import (CHUNK, F_DIM, PIXEL_GROUP, _counts,
                                     _slot_grads, pair_layout, peel_fused,
                                     peel_fused_bwd_torch, peel_topk,
                                     segment_rows, segment_rows_torch)
from rtgs_tpu_torch.render.binning import tile_candidates
from rtgs_tpu_torch.render.oracle import composite_hits
from rtgs_tpu_torch.render.tiled import (_tile_pixel_features, pack_features,
                                         precompute_features,
                                         render_tiled_keys,
                                         render_tiled_pallas)
from rtgs_tpu_torch.scene import random_scene
from rtgs_tpu_torch.viewer.orbit import orbit_camera_pose

FIELDS = ("means", "quats", "scales", "colors", "opacities", "sh")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _rows_ids(m, n_out, seed=0, device="cpu"):
    """Rows spanning twelve decades (the order of their sum shows in the
    low bits) and ids drawn from [0, n_out)."""
    rng = np.random.default_rng(seed)
    rows = (rng.standard_normal((m, F_DIM))
            * 10.0 ** rng.uniform(-6, 6, (m, 1))).astype(np.float32)
    ids = rng.integers(0, n_out, m).astype(np.int32)
    return (torch.from_numpy(rows).to(device),
            torch.from_numpy(ids).to(device))


# (rows, output rows): heavy collisions, one splat only, sparse, none.
SEGMENT_CASES = {"collisions": (20_000, 8), "one_row": (3000, 1),
                 "sparse": (300, 5000), "empty": (0, 7)}


# ----- stage 2: segment_rows -----

@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segment_rows_adds_row_by_row(case):
    """segment_rows_torch (what segment_rows runs on CPU tensors) equals
    ``zeros.index_add_`` and the sum taken row by row in ascending i,
    bitwise; rows no id names stay exactly 0."""
    m, n = SEGMENT_CASES[case]
    rows, ids = _rows_ids(m, n, seed=m)
    got = segment_rows(rows, ids, n)
    assert got.shape == (n, F_DIM) and got.dtype == torch.float32
    assert torch.equal(got, segment_rows_torch(rows, ids, n))
    assert torch.equal(got, torch.zeros((n, F_DIM)).index_add_(
        0, ids.long(), rows))
    want = torch.zeros((n, F_DIM))
    for i in range(m):
        want[ids[i]] = want[ids[i]] + rows[i]
    assert torch.equal(got, want)
    unnamed = torch.ones(n, dtype=torch.bool)
    unnamed[ids.long()] = False
    assert (got[unnamed] == 0).all()


def test_segment_rows_sentinel_row_stays_zero():
    """Zero rows aimed at the sentinel (the padding and −1 gaps of the
    pair buffer) leave it exactly 0, +0.0 included."""
    rows, ids = _rows_ids(500, 9, seed=3)
    ids[::3] = 9
    rows[::3] = 0.0
    rows[::6] = -0.0
    got = segment_rows(rows, ids, 10)
    assert (got[9] == 0).all() and not torch.signbit(got[9]).any()
    assert (got[:9] != 0).any()


@pytest.mark.parametrize("case", ["collisions", "sparse"])
def test_segment_rows_matches_jax_segment_sum(case):
    """Against jax.ops.segment_sum on the same numpy inputs (seeded), each
    entry to 1e-6 of the sum of its terms' magnitudes."""
    import jax
    import jax.numpy as jnp

    m, n = SEGMENT_CASES[case]
    rows, ids = _rows_ids(m, n, seed=11)
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(rows.numpy()),
                                         jnp.asarray(ids.numpy()),
                                         num_segments=n), np.float64)
    got = segment_rows_torch(rows, ids, n).numpy().astype(np.float64)
    mag = np.zeros((n, F_DIM))
    np.add.at(mag, ids.numpy(), np.abs(rows.numpy()).astype(np.float64))
    assert (np.abs(got - ref) <= 1e-6 * mag).all()
    assert np.abs(got).max() > 0


def test_segment_rows_cuda_refuses_cpu_tensors():
    """The kernel's wrapper raises on CPU tensors and wrong dtypes before
    any build or launch; the dispatcher never falls back."""
    rows, ids = _rows_ids(10, 4)
    before = T_PEEL.segment_rows_cuda.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        T_PEEL.segment_rows_cuda(rows, ids, 4)
    with pytest.raises(ValueError, match="ids is torch.int64"):
        T_PEEL.segment_rows_cuda(rows, ids.long(), 4)
    with pytest.raises(ValueError, match="rows has shape"):
        T_PEEL.segment_rows_cuda(rows[:, :32].contiguous(), ids, 4)
    assert T_PEEL.segment_rows_cuda.launches == before


# ----- stage 1: the pair layout and the order of a slot's sum -----

def test_pair_layout_compacts_swept_slots():
    """One row a swept (tile, slot) pair, tile by tile: pair_base is the
    exclusive prefix sum of the counts and M their sum (no row for the
    padding beyond a tile's count; interior gaps keep theirs)."""
    rng = np.random.default_rng(2)
    cand = rng.integers(0, 50, (5, 256)).astype(np.int32)
    for t, n in enumerate((0, 3, 256, 130, 77)):
        cand[t, n:] = -1
    cand[3, 10:40:4] = -1                       # interior gaps
    counts = _counts(torch.from_numpy(cand))
    base, m = pair_layout(counts)
    assert base.dtype == torch.int32 and isinstance(m, int)
    assert base.tolist() == [0, 0, 3, 259, 389] and m == 466
    base, m = pair_layout(counts[:0])
    assert base.numel() == 0 and m == 0


def _contraction_inputs(p, k=3, c=5, seed=0):
    """Random winners of one tile (distinct slots per pixel, some vacant)
    and random shading scalars and cotangents, (1, K, P) each."""
    g = torch.Generator().manual_seed(seed)
    slots = torch.stack([torch.randperm(c, generator=g)[:k]
                         for _ in range(p)], dim=1)[None].to(torch.int32)
    slots[torch.rand(slots.shape, generator=g) < 0.25] = -1
    cand = torch.arange(c, dtype=torch.int32)[None]
    pix = torch.randn((1, p, 24), generator=g)
    a = torch.rand(slots.shape, generator=g) + 0.5
    b = torch.randn(slots.shape, generator=g)
    rho = torch.rand(slots.shape, generator=g)
    alpha = rho * 0.9
    cots = [torch.randn(slots.shape, generator=g) for _ in range(4)]
    return cand, pix, slots, (a, b, rho, alpha, *cots)


@pytest.mark.parametrize("p", [64, 300])
def test_slot_rows_sum_in_kernel_order(p):
    """Each slot's row is the sum of its winners' rows taken pixel group
    (PIXEL_GROUP pixels a backward block) by pixel group, then layer by
    layer, then pixel by pixel: the order contract_slot_grads keeps on the
    card. Each winner's own row comes from the same function, every winner
    on a slot of its own."""
    cand, pix, slots, scal = _contraction_inputs(p)
    k = slots.shape[1]
    got = _slot_grads(cand, pix, slots, *scal)[0]
    kk, pp = torch.meshgrid(torch.arange(k), torch.arange(p), indexing="ij")
    own = torch.where(slots >= 0, (kk * p + pp)[None].to(torch.int32), -1)
    each = _slot_grads(torch.zeros((1, k * p), dtype=torch.int32), pix, own,
                       *scal)[0]
    want = torch.zeros_like(got)
    for grp in range(-(-p // PIXEL_GROUP)):
        for layer in range(k):
            for px in range(grp * PIXEL_GROUP, min(p, (grp + 1)
                                                   * PIXEL_GROUP)):
                s = int(slots[0, layer, px])
                if s >= 0:
                    want[s] = want[s] + each[layer * p + px]
    assert torch.equal(got, want)
    assert (got != 0).any()


# ----- the restructured backwards against the JAX VJPs -----

def _jax_inputs(n, res, tile, cmax, gmax, seed):
    from tests.test_torch_peel_fused import _inputs

    return _inputs(n, res, tile, cmax, gmax, seed=seed, dup=16)


@pytest.mark.parametrize("case", ["binned", "gaps"])
def test_fused_backward_matches_pallas_vjp(case):
    """peel_fused's gradient on CPU tensors (per-slot rows, then
    segment_rows) against jax.grad of peel_pallas (interpret mode), as
    tests/test_torch_peel_fused.py holds it; and the table is stage 2 of
    stage 1's rows, bitwise."""
    import jax
    import jax.numpy as jnp
    from rtgs_tpu.ops.peel import peel_pallas
    from tests.test_torch_peel_fused import _edit, assert_grads_close

    packed, cand, pix = _jax_inputs(80, (16, 16), (8, 8), 128, 1, seed=9)
    cand = _edit(cand, case)
    rng = np.random.default_rng(4)
    wr = rng.standard_normal((cand.shape[0], 3, pix.shape[1])).astype(
        np.float32)
    wt = rng.standard_normal((cand.shape[0], pix.shape[1])).astype(
        np.float32)

    def loss(p):
        rad, trans = peel_pallas(p, cand, pix, 8)
        return jnp.sum(rad * wr) + jnp.sum(trans * wt)

    ref = np.asarray(jax.grad(loss)(jnp.asarray(packed)))
    pk = torch.from_numpy(np.array(packed)).requires_grad_()
    tc = torch.from_numpy(np.array(cand))
    tp = torch.from_numpy(np.array(pix))
    rad, trans = peel_fused(pk, tc, tp, 8)
    (grad,) = torch.autograd.grad(
        (rad * torch.from_numpy(wr)).sum() + (trans * torch.from_numpy(
            wt)).sum(), pk)
    assert_grads_close(grad.numpy(), ref, name=case)
    assert (grad[-1] == 0).all()
    slots = T_PEEL.select_slots(pk.detach(), tc, tp, 8)
    per_slot = peel_fused_bwd_torch(pk.detach(), tc, tp, slots,
                                    torch.from_numpy(wr),
                                    torch.from_numpy(wt))
    swept = torch.arange(tc.shape[1]) < _counts(tc)[:, None]
    assert torch.equal(grad, segment_rows(per_slot[swept], tc[swept],
                                          packed.shape[0]))


def test_topk_backward_matches_pallas_vjp():
    """The K-list's gradient (peel_topk on CPU tensors, composited by
    composite_hits) against jax.grad through peel_topk_pallas, at
    tests/test_torch_peel_topk.py's bounds."""
    from tests.test_torch_peel_topk import _grad_topk, _j_via_topk

    packed, cand, pix = _jax_inputs(80, (16, 16), (8, 8), 128, 1, seed=9)
    w_rad = np.random.default_rng(5).standard_normal(
        (cand.shape[0], pix.shape[1], 3)).astype(np.float32)
    got = _grad_topk(packed, cand, pix, 8, w_rad)
    ref = _j_via_topk(packed, cand, pix, 8, w_rad)
    rel = np.abs(got - ref) / np.abs(ref).max()
    assert np.abs(got).max() > 0 and np.isfinite(got).all()
    assert rel.max() < 2e-3 and np.quantile(rel, 0.99) < 2e-4, (
        rel.max(), np.quantile(rel, 0.99))


def test_keys_shade_backward_matches_jax_vjp():
    """shade_winners_kp's backward, now a segment_rows of the winners'
    rows, against the JAX VJP at tests/test_torch_keys_grad.py's bounds,
    with the sentinel row exactly 0."""
    import jax
    import jax.numpy as jnp
    from rtgs_tpu.render import tiled as jtiled
    from tests.test_torch_keys_grad import _port_vjp, _shade_inputs

    packed, sid, pix, _ = _shade_inputs(n=600, seed=8)
    rng = np.random.default_rng(6)
    cots = [rng.standard_normal(sid.shape).astype(np.float32)
            for _ in range(4)]
    _, vjp = jax.vjp(lambda p: jtiled.shade_winners_kp(
        p, jnp.asarray(sid), jnp.asarray(pix)), jnp.asarray(packed))
    ref = np.asarray(vjp(tuple(jnp.asarray(c) for c in cots))[0])
    _, got = _port_vjp(packed, sid, pix, cots)
    n = packed.shape[0] - 1
    scale = np.abs(ref[:n]).max(axis=0)
    err = np.abs(got[:n] - ref[:n])
    assert (err <= 1e-5 * np.abs(ref[:n]) + 1e-6 * scale).all()
    assert (got[n] == 0).all() and (scale[:59] > 0).all()


# ----- whole paths, twice: bitwise -----

PATHS = ("pallas", "keys", "topk")


def _frame(device):
    """The JAX test's frame: 300 splats at 64×48, depth 16."""
    g = random_scene(300, extent=1.0, scale_range=(0.02, 0.1), seed=0,
                     device=device)
    pos, rot, _, _ = orbit_camera_pose(0.3, 1.2, 3.0, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    return g, camera_from_fov(pos, rot, (64, 48), 60.0, device=device)


def _render(path, g, cam):
    kw = dict(depth=16, max_candidates=256, max_global=32)
    if path == "pallas":
        return render_tiled_pallas(g, cam, **kw)
    if path == "keys":
        return render_tiled_keys(g, cam, tile_bands=2, **kw)
    b = tile_candidates(g, cam, tile=(16, 16), max_candidates=256,
                        max_global=32, chunk=CHUNK)
    packed = pack_features(precompute_features(g, cam))
    t1, a, r, gg, bb = peel_topk(packed, b.candidates,
                                 _tile_pixel_features(cam, (16, 16)), 16)
    rad, trans = composite_hits(t1, a, torch.stack([r, gg, bb], -1))
    return torch.cat([rad, trans[..., None]], -1)


def _render_and_grad(path, g, cam, weight):
    leaves = [getattr(g, f).detach().clone().requires_grad_()
              for f in FIELDS]
    scene = dataclasses.replace(g, **dict(zip(FIELDS, leaves)))
    img = _render(path, scene, cam)
    grads = torch.autograd.grad((img * weight(img)).sum(), leaves)
    return img.detach(), grads


def _assert_repeats(path, device):
    assert not torch.are_deterministic_algorithms_enabled()
    g, cam = _frame(device)
    gen = torch.Generator().manual_seed(1)

    def weight(img):
        return torch.randn(img.shape, generator=gen).to(device)

    img_a, grads_a = _render_and_grad(path, g, cam, weight)
    gen.manual_seed(1)
    img_b, grads_b = _render_and_grad(path, g, cam, weight)
    assert img_a.abs().max() > 0.05
    assert torch.equal(img_a, img_b)
    for f, ga, gb in zip(FIELDS, grads_a, grads_b):
        assert torch.isfinite(ga).all() and ga.abs().max() > 0, f
        assert torch.equal(ga, gb), (path, f)


@pytest.mark.parametrize("path", PATHS)
def test_render_and_gradient_repeat_bitwise(path):
    """The port's counterpart of tests/test_tiled.py:150 for the pallas,
    keys (2 bands, recomputed) and top-K paths: render twice and take the
    scene gradient twice, bitwise equal, with torch's deterministic mode
    off."""
    _assert_repeats(path, torch.device("cpu"))


# ----- on the card -----

@pytest.mark.cuda
@pytest.mark.parametrize("path", PATHS)
def test_render_and_gradient_repeat_bitwise_on_card(cuda, path):
    """As above, through the Hopper kernels (keys.cu, peel_fwd.cu,
    peel_bwd.cu, peel_topk_fwd.cu, peel_topk_bwd.cu, segment_rows.cu)."""
    before = T_PEEL.segment_rows_cuda.launches
    _assert_repeats(path, cuda)
    assert T_PEEL.segment_rows_cuda.launches > before


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segment_rows_kernel_matches_cpu_twin(cuda, case):
    """segment_rows.cu against segment_rows_torch on the CPU, bitwise, and
    against itself on a second launch; ids outside [0, n_out) skipped."""
    m, n = SEGMENT_CASES[case]
    rows, ids = _rows_ids(m, n, seed=m)
    want = segment_rows_torch(rows, ids, n)
    got = T_PEEL.segment_rows_cuda(rows.to(cuda), ids.to(cuda), n)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(T_PEEL.segment_rows_cuda(rows.to(cuda), ids.to(cuda),
                                                n), got)
    if m:
        wild = ids.clone()
        wild[::7] = -3
        wild[1::7] = n + 2
        keep = (wild >= 0) & (wild < n)
        got = T_PEEL.segment_rows_cuda(rows.to(cuda), wild.to(cuda), n)
        assert torch.equal(got.cpu(),
                           segment_rows_torch(rows[keep], wild[keep], n))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(16, 16), (32, 16)])
def test_pair_rows_match_twin_and_repeat(cuda, tile):
    """Stage 1 on the card, the fused and the top-K kernel (table=False):
    each pair row against the twin's per-slot row of the same (tile,
    slot), per lane to 1e-4 of the lane's largest entry; launched twice,
    bitwise. 32×16 tiles have two pixel groups of 256."""
    g = random_scene(3000, extent=0.6, scale_range=(0.01, 0.06), seed=2,
                     device=cuda)
    pos, rot, _, _ = orbit_camera_pose(0.3, 1.2, 2.0, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    cam = camera_from_fov(pos, rot, (64, 48), 60.0, device=cuda)
    b = tile_candidates(g, cam, tile=tile, max_candidates=1024,
                        max_global=64, chunk=CHUNK)
    cand = b.candidates.clone()
    cand[:, 5::9] = -1
    packed = pack_features(precompute_features(g, cam))
    pix = _tile_pixel_features(cam, tile)
    counts = _counts(cand)
    swept = torch.arange(cand.shape[1], device=cuda) < counts[:, None]
    _, _, sl = T_PEEL.peel_fused_cuda(packed, cand, counts, pix, 16)
    gen = torch.Generator(device=cuda).manual_seed(7)
    t, p = cand.shape[0], pix.shape[1]
    g_rad = torch.randn((t, 3, p), generator=gen, device=cuda)
    g_tr = torch.randn((t, p), generator=gen, device=cuda)
    g_lay = torch.randn((t, 4, 16, p), generator=gen, device=cuda)
    runs = {
        "fused": (lambda: T_PEEL.peel_fused_bwd_cuda(
            packed, cand, counts, pix, sl, g_rad, g_tr, 16, table=False),
            lambda: T_PEEL.peel_fused_bwd_torch(packed, cand, pix, sl, g_rad,
                                                g_tr)),
        "topk": (lambda: T_PEEL.peel_topk_bwd_cuda(
            packed, cand, counts, pix, sl, g_lay, 16, table=False),
            lambda: T_PEEL.peel_topk_bwd_torch(packed, cand, pix, sl,
                                               g_lay)),
    }
    for name, (kernel, twin) in runs.items():
        rows, ids = kernel()
        again, ids2 = kernel()
        ref = twin()[swept]
        assert rows.shape == ref.shape
        assert torch.equal(ids, cand[swept]) and torch.equal(ids2, ids)
        assert torch.equal(rows, again), name
        scale = ref.abs().amax(0) + 1e-30
        assert float(((rows - ref).abs().amax(0) / scale).max()) <= 1e-4
        assert (rows[:, 59:] == 0).all() and rows.abs().max() > 0
