"""The port's fused peel (rtgs_tpu_torch.ops.peel: the plain forward
peel_fused_torch, the plain backward peel_fused_bwd_torch and the autograd
Function behind peel_fused) against the JAX package's peel_reference, its
autodiff, and its Pallas kernel peel_pallas (interpret mode on the CPU, as
tests/test_peel_pallas.py runs it), on the same packed table, candidates
(the JAX binning's) and pixel features.

32 splats are duplicated so that exact t1 ties exist; the lower candidate
slot must win, in both packages. The port selects by a float64 t1 and the
JAX package by an f32 one, so near ties may reorder and grazing pixels may
flip: images are compared with tests/_utils.assert_images_close and
feature gradients by quantile, as the JAX package compares its own
renderers. The port's backward against autograd of its own forward is the
same arithmetic and must agree to f32 rounding (1e-5 of the largest
entry)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtgs_tpu import gaussians as JG
from rtgs_tpu.camera import camera_from_fov
from rtgs_tpu.ops.peel import CHUNK as J_CHUNK
from rtgs_tpu.ops.peel import peel_pallas, peel_reference
from rtgs_tpu.render.binning import tile_candidates
from rtgs_tpu.render.tiled import (_tile_pixel_features, pack_features,
                                   precompute_features)
from rtgs_tpu.viewer.orbit import orbit_camera_pose
from rtgs_tpu_torch.ops.peel import (CHUNK, F_DIM, peel_fused,
                                     peel_fused_bwd_torch, peel_fused_torch,
                                     select_slots)
from rtgs_tpu_torch.scene import random_scene_arrays
from tests._utils import assert_images_close


def _inputs(n, res, tile, cmax, gmax, seed=5, dup=32):
    fields = random_scene_arrays(n, 1.0, (0.02, 0.1), seed=seed)
    fields = {k: np.concatenate([v, v[:dup]]) for k, v in fields.items()}
    g = JG.Gaussians(**{k: jnp.asarray(v) for k, v in fields.items()})
    pos, rot, _, _ = orbit_camera_pose(0.3, 1.2, 3.0, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    cam = camera_from_fov(pos, rot, res, 60.0)
    b = tile_candidates(g, cam, tile=tile, max_candidates=cmax,
                        max_global=gmax)
    cand = np.asarray(b.candidates)
    cand = np.pad(cand, ((0, 0), (0, (-cand.shape[1]) % J_CHUNK)),
                  constant_values=-1)
    packed = np.asarray(pack_features(precompute_features(g, cam)))
    pix = np.asarray(_tile_pixel_features(cam, tile))
    return packed, cand, pix


@pytest.fixture(scope="module")
def peel_inputs():
    """300 + 32 duplicated splats at 32×32, 16×16 tiles."""
    return _inputs(300, (32, 32), (16, 16), 384, 32)


@pytest.fixture(scope="module")
def small_inputs():
    """The shapes of test_peel_pallas.py's backward test: 16×16 at 8×8
    tiles, one candidate chunk."""
    return _inputs(80, (16, 16), (8, 8), 128, 1, seed=7, dup=16)


def _edit(cand, case):
    """Candidate fixtures: as binned; one tile emptied; interior −1 gaps
    (every fifth valid slot of every tile)."""
    cand = cand.copy()
    if case == "empty_tile":
        busiest = int(np.argmax((cand >= 0).sum(1)))
        cand[busiest] = -1
    elif case == "gaps":
        cand[:, ::5] = np.where(cand[:, ::5] >= 0, -1, cand[:, ::5])
    return cand


def _t(x):
    return torch.from_numpy(np.array(x))


def _cotangents(shape_rad, shape_trans, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_rad).astype(np.float32),
            rng.standard_normal(shape_trans).astype(np.float32))


def _jax_grad(fn, packed, cand, pix, depth, wr, wt):
    def loss(p):
        rad, trans = fn(p, cand, pix, depth)
        return jnp.sum(rad * wr) + jnp.sum(trans * wt)

    return np.asarray(jax.grad(loss)(jnp.asarray(packed)))


def _port_grad(packed, cand, pix, depth, wr, wt):
    pk = _t(packed).requires_grad_()
    rad, trans = peel_fused(pk, _t(cand), _t(pix), depth)
    ((rad * _t(wr)).sum() + (trans * _t(wt)).sum()).backward()
    return pk.grad.numpy()


def assert_grads_close(got, ref, q99=1e-3, max_rel=0.2, name=""):
    """The JAX package's quantile bound on scene gradients
    (test_peel_pallas.py:test_pallas_scene_gradients)."""
    assert np.isfinite(got).all(), name
    rel = np.abs(got - ref) / (np.abs(ref).max() + 1e-8)
    assert np.quantile(rel, 0.99) < q99, (name, np.quantile(rel, 0.99))
    assert rel.max() < max_rel, (name, rel.max())


@pytest.mark.parametrize("depth", [1, 8, 16])
def test_forward_matches_reference(peel_inputs, depth):
    packed, cand, pix = peel_inputs
    rad_j, trans_j = peel_reference(packed, cand, pix, depth)
    rad, trans, slots = peel_fused_torch(_t(packed), _t(cand), _t(pix),
                                         depth)
    assert rad.shape == (cand.shape[0], 3, pix.shape[1])
    assert trans.shape == (cand.shape[0], pix.shape[1])
    assert slots.shape == (cand.shape[0], depth, pix.shape[1])
    assert rad.abs().max() > 0.1
    assert_images_close(rad.numpy(), np.asarray(rad_j))
    assert_images_close(trans.numpy(), np.asarray(trans_j))


def test_forward_matches_pallas_kernel(small_inputs):
    packed, cand, pix = small_inputs
    rad_j, trans_j = peel_pallas(packed, cand, pix, 8)
    rad, trans, _ = peel_fused_torch(_t(packed), _t(cand), _t(pix), 8)
    assert_images_close(rad.numpy(), np.asarray(rad_j))
    assert_images_close(trans.numpy(), np.asarray(trans_j))


def test_backward_matches_pallas_autodiff(small_inputs):
    """The port's plain backward (through peel_fused on CPU tensors)
    against jax.grad of the Pallas kernel's hand-written VJP, random
    cotangents on both outputs."""
    packed, cand, pix = small_inputs
    wr, wt = _cotangents((cand.shape[0], 3, pix.shape[1]),
                         (cand.shape[0], pix.shape[1]))
    ref = _jax_grad(peel_pallas, packed, cand, pix, 8, wr, wt)
    got = _port_grad(packed, cand, pix, 8, wr, wt)
    assert np.abs(got).max() > 0
    assert_grads_close(got, ref)


@pytest.mark.parametrize("case", ["binned", "empty_tile", "gaps"])
def test_fixtures_match_reference(peel_inputs, case):
    """Forward and gradient against peel_reference and its autodiff with
    an emptied tile, interior −1 gaps, and counts short of C."""
    packed, cand, pix = peel_inputs
    cand = _edit(cand, case)
    assert (cand < 0).any(axis=1).all()       # every count is short of C
    rad_j, trans_j = peel_reference(packed, cand, pix, 8)
    rad, trans, _ = peel_fused_torch(_t(packed), _t(cand), _t(pix), 8)
    assert_images_close(rad.numpy(), np.asarray(rad_j))
    assert_images_close(trans.numpy(), np.asarray(trans_j))
    if case == "empty_tile":
        busiest = int(np.argmax((peel_inputs[1] >= 0).sum(1)))
        assert (rad[busiest] == 0).all() and (trans[busiest] == 1).all()
    wr, wt = _cotangents(tuple(rad.shape), tuple(trans.shape))
    ref = _jax_grad(peel_reference, packed, cand, pix, 8, wr, wt)
    assert_grads_close(_port_grad(packed, cand, pix, 8, wr, wt), ref,
                       name=case)


def test_ties_go_to_the_lower_slot(peel_inputs):
    """Duplicated splats tie exactly in t1; the earlier candidate slot
    takes the nearer layer, and the lists are sorted by (t1, slot)."""
    packed, cand, pix = map(_t, peel_inputs)
    slots = select_slots(packed, cand, pix, 16)            # (T, K, P)
    n = packed.shape[0] - 1 - 32
    ids = torch.where(slots >= 0, cand.gather(
        1, slots.clamp(min=0).flatten(1).long()).reshape(slots.shape), -1)
    a, b = slots[:, :-1], slots[:, 1:]
    twin = (ids[:, 1:] >= n) & (ids[:, :-1] == ids[:, 1:] - n)
    twin |= (ids[:, :-1] >= n) & (ids[:, 1:] == ids[:, :-1] - n)
    assert twin.any()                                      # real ties
    assert (a[twin] < b[twin]).all()


@pytest.mark.parametrize("case", ["binned", "gaps"])
def test_backward_matches_autograd(peel_inputs, case):
    """The hand-written plain backward equals torch autograd of the plain
    forward: the same arithmetic, so agreement is to f32 rounding."""
    packed, cand, pix = peel_inputs
    cand = _edit(cand, case)
    wr, wt = _cotangents((cand.shape[0], 3, pix.shape[1]),
                         (cand.shape[0], pix.shape[1]))
    got = _port_grad(packed, cand, pix, 16, wr, wt)
    pk = _t(packed).requires_grad_()
    rad, trans, _ = peel_fused_torch(pk, _t(cand), _t(pix), 16)
    ((rad * _t(wr)).sum() + (trans * _t(wt)).sum()).backward()
    ref = pk.grad.numpy()
    scale = np.abs(ref).max()
    assert scale > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-5)
    # The sentinel row's gradient stays finite (it is all zeros).
    assert (got[-1] == 0).all()


def test_per_slot_gradients_and_dispatch(peel_inputs):
    """peel_fused_bwd_torch returns per-slot rows (T, C, 64): padding and
    losing slots stay zero, lanes 59:64 stay zero. Unknown impls raise,
    and the kernels refuse CPU tensors (no silent fallback)."""
    packed, cand, pix = map(_t, peel_inputs)
    rad, trans, slots = peel_fused_torch(packed, cand, pix, 8)
    wr, wt = map(_t, _cotangents(tuple(rad.shape), tuple(trans.shape)))
    d = peel_fused_bwd_torch(packed, cand, pix, slots, wr, wt)
    assert d.shape == (cand.shape[0], cand.shape[1], F_DIM)
    won = torch.zeros(cand.shape, dtype=torch.bool)
    for t in range(cand.shape[0]):
        s = slots[t][slots[t] >= 0].long()
        won[t, s] = True
    assert (d[~won] == 0).all() and (d[..., 59:] == 0).all()
    assert (d[won].abs().sum(-1) > 0).any()
    assert CHUNK == J_CHUNK
    rad2, trans2 = peel_fused(packed, cand, pix, 8, impl="torch")
    assert torch.equal(rad2, rad) and torch.equal(trans2, trans)
    with pytest.raises(ValueError, match="unknown peel impl"):
        peel_fused(packed, cand, pix, 8, impl="pallas")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        peel_fused(packed, cand, pix, 8, impl="cuda")
