"""The port's LBVH (rtgs_tpu_torch.bvh) against the JAX package's: the
cases of tests/test_bvh.py on the port, then the Morton codes and the whole
tree (children, escapes, leaves and boxes) equal to JAX's ``build_lbvh`` on
the same f32 scene, and ``bvh_hit`` against JAX's on the same rays.

Both packages evaluate the same f32 ray quadratic for t1 and t2, but from
Σ⁻¹ assembled by a different sequence of f32 operations: the hit indices
are held exactly, t1 and t2 to 2e-5 relative (a quadratic cancels) plus
the rounding of Δ amplified near a tangent (``DELTA_ULPS``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtgs_tpu import bvh as jbvh
from rtgs_tpu import gaussians as JG
from rtgs_tpu.rays import new_rays as j_new_rays
from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.bridge import gaussians_from_numpy
from rtgs_tpu_torch.bvh import (LBVH, _clz32, build_lbvh, bvh_hit,
                                morton_codes)
from rtgs_tpu_torch.rays import new_rays
from rtgs_tpu_torch.scene import random_scene, random_scene_arrays

T1_RTOL = 2e-5
# Near a tangent the roots move by the rounding of Δ over √Δ: relative to
# t, by (Δ's relative rounding) · t / (t2 − t1). Σ⁻¹ is assembled by
# different f32 operations in the two packages, so Δ differs by a few
# ulps of B².
DELTA_ULPS = 4 * 2.0**-23


def _scene(n, seed=0, extent=1.0):
    return random_scene(n, extent=extent, seed=seed, device="cpu")


def test_morton_orders_locality():
    pts = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.01, 0.0, 0.0]])
    codes = morton_codes(pts, torch.zeros(3), torch.ones(3))
    assert codes[0] == codes[2] or abs(int(codes[0]) - int(codes[2])) < int(
        codes[1])


def _check_tree(bvh: LBVH, n):
    left, right, prim = bvh.left.numpy(), bvh.right.numpy(), bvh.prim.numpy()
    # Every node except the root has exactly one parent.
    children = np.concatenate([left[: n - 1], right[: n - 1]])
    assert len(children) == 2 * (n - 1)
    counts = np.bincount(children, minlength=2 * n - 1)
    assert counts[0] == 0
    assert (counts[1:] == 1).all()
    # Leaves hold a permutation of primitives.
    assert sorted(prim[n - 1:].tolist()) == list(range(n))
    # Parents contain their children.
    pmin, pmax = bvh.pmin.numpy(), bvh.pmax.numpy()
    for i in range(n - 1):
        for ch in (left[i], right[i]):
            assert (pmin[i] <= pmin[ch] + 1e-5).all(), (i, ch)
            assert (pmax[i] >= pmax[ch] - 1e-5).all(), (i, ch)


def test_build_structure():
    g = _scene(64)
    _check_tree(build_lbvh(g.means, g.quats, g.scales, g.mask), 64)


@pytest.mark.parametrize("n", [2, 3, 7, 33])
def test_build_structure_odd_sizes(n):
    g = _scene(n, seed=n)
    _check_tree(build_lbvh(g.means, g.quats, g.scales, g.mask), n)


def test_build_duplicate_positions():
    """Equal Morton codes still build a valid tree (index tie-break)."""
    g = _scene(16)
    means = g.means.clone()
    means[4:8] = means[0]
    _check_tree(build_lbvh(means, g.quats, g.scales, g.mask), 16)


def test_escape_traversal_visits_all_leaves():
    """Following left-child/escape links from the root enumerates every
    leaf exactly once."""
    n = 32
    g = _scene(n)
    bvh = build_lbvh(g.means, g.quats, g.scales, g.mask)
    left, escape, prim = (bvh.left.numpy(), bvh.escape.numpy(),
                          bvh.prim.numpy())
    seen, node, steps = [], 0, 0
    while node >= 0 and steps < 10 * n:
        if prim[node] >= 0:
            seen.append(int(prim[node]))
            node = escape[node]
        else:
            node = left[node]
        steps += 1
    assert sorted(seen) == list(range(n))


def _random_rays(n, seed=1, spread=3.0):
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return origins, dirs


def test_bvh_hit_matches_bruteforce():
    g = _scene(200)
    bvh = build_lbvh(g.means, g.quats, g.scales, g.mask)
    origins, dirs = _random_rays(128)
    hit = bvh_hit(bvh, g, new_rays(origins, dirs, device="cpu"))

    o, d = torch.from_numpy(origins), torch.from_numpy(dirs)
    t1, _ = G.hit(G.inv_covariance(g.quats, g.scales), g.means, o[:, None],
                  d[:, None])
    t1m = torch.where((t1 > 0) & torch.isfinite(t1), t1, np.inf).numpy()
    miss = ~np.isfinite(t1m.min(-1))
    brute_idx = np.where(miss, -1, t1m.argmin(-1))
    np.testing.assert_array_equal(hit.gaussian_idx.numpy(), brute_idx)
    got = hit.t1.numpy()
    np.testing.assert_allclose(got[~miss], t1m.min(-1)[~miss], rtol=1e-5)
    assert np.isinf(got[miss]).all()
    assert (hit.steps.numpy() < 4096).all()


def test_bvh_hit_respects_interval():
    """start/end clipping (open interval), the reference accept rule."""
    g = _scene(50)
    bvh = build_lbvh(g.means, g.quats, g.scales, g.mask)
    o, d = [[0.0, 0.0, 3.0]], [[0.0, 0.0, -1.0]]
    free = bvh_hit(bvh, g, new_rays(o, d, device="cpu"))
    assert int(free.gaussian_idx[0]) >= 0
    clipped = bvh_hit(bvh, g, new_rays(o, d,
                                       starts=float(free.t1[0]) + 1e-4,
                                       device="cpu"))
    if int(clipped.gaussian_idx[0]) >= 0:
        assert float(clipped.t1[0]) > float(free.t1[0])


def test_bvh_masked_primitives_invisible():
    g = _scene(40, extent=0.5)
    rays = new_rays([[0.0, 0.0, 3.0]], [[0.0, 0.0, -1.0]], device="cpu")
    first = bvh_hit(build_lbvh(g.means, g.quats, g.scales, g.mask), g, rays)
    assert int(first.gaussian_idx[0]) >= 0
    mask2 = g.mask.clone()
    mask2[int(first.gaussian_idx[0])] = 0.0
    g2 = G.Gaussians(**{**{f: getattr(g, f) for f in G.FIELDS},
                        "mask": mask2})
    second = bvh_hit(build_lbvh(g2.means, g2.quats, g2.scales, g2.mask), g2,
                     rays)
    assert int(second.gaussian_idx[0]) != int(first.gaussian_idx[0])


def test_lbvh_all_duplicate_morton_codes():
    """Thousands of Gaussians at one position: every Morton code equal, the
    deep-tree case the fixed propagation-pass count must still cover."""
    n = 4096
    means = torch.zeros((n, 3)) + 0.5
    quats = torch.zeros((n, 4))
    quats[:, 3] = 1.0
    scales = torch.full((n, 3), 0.01)
    bvh = build_lbvh(means, quats, scales)
    pmin, pmax = G.aabb(means, quats, scales)
    assert float(bvh.pmin[0, 0]) <= float(pmin[:, 0].min()) + 1e-5
    assert float(bvh.pmax[0, 0]) >= float(pmax[:, 0].max()) - 1e-5
    g = G.Gaussians(means=means, quats=quats, scales=scales,
                    colors=torch.full((n, 3), 0.5),
                    opacities=torch.full((n,), 0.8),
                    sh=torch.zeros((n, 15, 3)), mask=torch.ones((n,)))
    hit = bvh_hit(bvh, g, new_rays([[0.5, 0.5, -5.0]], [[0.0, 0.0, 1.0]],
                                   device="cpu"))
    assert int(hit.gaussian_idx[0]) >= 0
    assert np.isfinite(float(hit.t1[0]))
    assert int(hit.steps[0]) == 4096       # cut, and the hit found anyway


def _both(n, seed):
    fields = random_scene_arrays(n, 1.0, (0.02, 0.1), seed=seed)
    return (JG.Gaussians(**{k: jnp.asarray(v) for k, v in fields.items()}),
            gaussians_from_numpy(fields, device="cpu"))


def test_morton_codes_match_jax():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-2, 2, (500, 3)).astype(np.float32)
    lo, hi = pts.min(0), pts.max(0)
    ref = np.asarray(jbvh.morton_codes(jnp.asarray(pts), jnp.asarray(lo),
                                       jnp.asarray(hi)))
    got = morton_codes(torch.from_numpy(pts), torch.from_numpy(lo),
                       torch.from_numpy(hi))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    x = torch.tensor([0, 1, 2, 3, 255, 256, 2**30 - 1, 2**31, 2**32 - 1])
    assert _clz32(x).tolist() == jbvh._clz32(jnp.asarray(
        x.numpy().astype(np.uint32))).tolist()


@pytest.mark.parametrize("n,dup", [(33, False), (300, True)])
def test_tree_equals_jax(n, dup):
    """The whole tree, bitwise, with the stable sort keeping duplicate
    codes in JAX's order."""
    jg, tg = _both(n, seed=n)
    if dup:
        jg = jg._replace(means=jg.means.at[4:20].set(jg.means[0]))
        tg.means[4:20] = tg.means[0].clone()
    jt = jbvh.build_lbvh(jg.means, jg.quats, jg.scales, jg.mask)
    tt = build_lbvh(tg.means, tg.quats, tg.scales, tg.mask)
    for name in LBVH._fields:
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)),
                                      err_msg=name)


def test_bvh_hit_matches_jax():
    jg, tg = _both(300, seed=9)
    mask = np.ones(300, np.float32)
    mask[::7] = 0.0                        # some dead splats
    jg = jg._replace(mask=jnp.asarray(mask))
    tg.mask.copy_(torch.from_numpy(mask))
    rng = np.random.default_rng(2)
    origins = rng.uniform(-3, 3, (96, 3)).astype(np.float32)
    aim = rng.uniform(-0.8, 0.8, (96, 3)).astype(np.float32)
    dirs = (aim - origins) / np.linalg.norm(aim - origins, axis=-1,
                                            keepdims=True)
    jh = jbvh.bvh_hit(jbvh.build_lbvh(jg.means, jg.quats, jg.scales,
                                      jg.mask), jg,
                      j_new_rays(origins, dirs))
    th = bvh_hit(build_lbvh(tg.means, tg.quats, tg.scales, tg.mask), tg,
                 new_rays(origins, dirs, device="cpu"))
    idx = np.asarray(jh.gaussian_idx)
    np.testing.assert_array_equal(th.gaussian_idx.numpy(), idx)
    hit = idx >= 0
    assert hit.sum() > 10
    t1, t2 = np.asarray(jh.t1)[hit], np.asarray(jh.t2)[hit]
    for name, ref in (("t1", t1), ("t2", t2)):
        got = getattr(th, name).numpy()[hit]
        tol = T1_RTOL * np.abs(ref) + DELTA_ULPS * ref ** 2 / (t2 - t1)
        assert (np.abs(got - ref) <= tol).all(), name
    assert np.isinf(th.t1.numpy()[~hit]).all()
