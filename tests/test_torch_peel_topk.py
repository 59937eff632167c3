"""The port's top-K peel (rtgs_tpu_torch.ops.peel: the plain forward
peel_topk_torch, the plain backward peel_topk_bwd_torch and the autograd
Function behind peel_topk) against the JAX package's peel_topk_xla and its
Pallas kernel peel_topk_pallas (interpret mode on the CPU, as
tests/test_peel_pallas.py runs it), on the same packed table, candidates
(the JAX binning's) and pixel features.

Tolerances. The port's t1 is the float64 chain rounded once and the JAX
package's an f32 chain, whose error grows with κ = |B|/√Δ: t1 agrees
within rtol max(1e-5, 8·2⁻²⁴·κ), as in tests/test_torch_keys.py. The
vacancy pattern and the order agree exactly at these inputs (exact ties
among the 32 duplicated splats go to the lower slot in both). rgb is a
well-conditioned f32 sum and agrees to 1e-5. α's exponent B²/4A − (c0+3)
cancels, and the two packages sum A and B in other orders (the Pallas
kernel also goes through log(op)), so α is compared with the statistic of
tests/_utils.assert_images_close. Within the port, the K-list composited by
composite_hits equals peel_fused to 1e-6, and the hand-written backward
equals autograd of the twin to 1e-5 of the largest entry. Against
jax.grad of the JAX test's via_topk: that test's rtol 1e-4 and atol 1e-5
on the hand-made fixture whose α are exact; on a random scene the f32 α
of either package is off float64 by 3.8e-4 (median; 5e-3 max), so the
gradients agree to 2e-3 of the largest entry, 99% of them to 2e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtgs_tpu.ops.peel import CHUNK as J_CHUNK
from rtgs_tpu.ops.peel import peel_topk_pallas, peel_topk_xla
from rtgs_tpu.render.oracle import composite_hits as j_composite_hits
from rtgs_tpu_torch.ops.peel import (CHUNK, F_DIM, G_DIM, PeelTopK,
                                     peel_fused, peel_topk,
                                     peel_topk_bwd_torch, peel_topk_torch)
from rtgs_tpu_torch.render.oracle import composite_hits
from tests._utils import assert_images_close
from tests.test_torch_keys import _conditioning
from tests.test_torch_peel_fused import _edit, _inputs


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def peel_inputs():
    """300 + 32 duplicated splats at 32×32, 16×16 tiles."""
    return _inputs(300, (32, 32), (16, 16), 384, 32)


@pytest.fixture(scope="module")
def small_inputs():
    """The shapes of test_peel_pallas.py's top-K test: 16×16 at 8×8
    tiles, one candidate chunk."""
    return _inputs(80, (16, 16), (8, 8), 128, 1, seed=7, dup=16)


def _layers(packed, cand, pix, depth):
    """The twin's (t1, α, r, g, b), each (T, P, K), and slots (T, K, P)."""
    layers, slots = peel_topk_torch(_t(packed), _t(cand), _t(pix), depth)
    return [x.numpy() for x in layers.transpose(2, 3).unbind(1)], slots


def _assert_layers_close(port, ref, packed, pix, slots, cand):
    t1, alpha, r, g, b = port
    t1_j, alpha_j, r_j, g_j, b_j = (np.asarray(x) for x in ref)
    fin = np.isfinite(t1_j)
    assert t1.shape == t1_j.shape
    np.testing.assert_array_equal(np.isfinite(t1), fin)
    assert fin.any() and (~fin).any()
    sid = np.where(slots >= 0, np.take_along_axis(
        cand, np.maximum(slots, 0).reshape(cand.shape[0], -1), 1).reshape(
            slots.shape), -1)
    kappa = _conditioning(packed, pix, sid).transpose(0, 2, 1)
    rtol = np.maximum(1e-5, 8 * 2.0**-24 * kappa)
    err = np.abs(t1[fin] - t1_j[fin]) / np.abs(t1_j[fin])
    assert (err <= rtol[fin]).all(), (err / rtol[fin]).max()
    for got, want in ((r, r_j), (g, g_j), (b, b_j)):
        np.testing.assert_allclose(got[fin], want[fin], atol=1e-5)
        assert (got[~fin] == 0).all()
    assert (alpha[~fin] == 0).all() and (alpha_j[~fin] == 0).all()
    assert_images_close(alpha, alpha_j)


@pytest.mark.parametrize("depth", [8, 16])
def test_twin_matches_xla(peel_inputs, depth):
    packed, cand, pix = peel_inputs
    port, slots = _layers(packed, cand, pix, depth)
    ref = peel_topk_xla(packed, cand, pix, depth)
    _assert_layers_close(port, ref, packed, pix, slots.numpy(), cand)


def test_twin_matches_pallas_kernel(small_inputs):
    packed, cand, pix = small_inputs
    assert CHUNK == J_CHUNK
    port, slots = _layers(packed, cand, pix, 8)
    ref = peel_topk_pallas(packed, cand, pix, 8)
    _assert_layers_close(port, ref, packed, pix, slots.numpy(), cand)


@pytest.mark.parametrize("case", ["binned", "empty_tile", "gaps"])
def test_composite_matches_fused(peel_inputs, case):
    """composite_hits(*peel_topk(...)) is the fused peel, composited
    outside: radiance and transmittance to 1e-6."""
    packed, cand, pix = peel_inputs
    cand = _t(_edit(cand, case))
    t1, a, r, g, b = peel_topk(_t(packed), cand, _t(pix), 16)
    assert t1.shape == (cand.shape[0], pix.shape[1], 16)
    rad, trans = composite_hits(t1, a, torch.stack([r, g, b], dim=-1))
    rad_f, trans_f = peel_fused(_t(packed), cand, _t(pix), 16)
    assert rad.abs().max() > 0.1
    assert (rad - rad_f.transpose(1, 2)).abs().max() <= 1e-6
    assert (trans - trans_f).abs().max() <= 1e-6


def _grad_topk(packed, cand, pix, depth, w_rad, w_layers=None, fn=None):
    """∂/∂packed of Σ w_rad·radiance + Σ transmittance of the composited
    K-list, plus Σ w_layers·(t1, α, r, g, b) when given (t1's finite
    entries included: its cotangent must be dropped). ``fn`` makes the
    (T, P, K) lists; the default is peel_topk (its hand-written
    backward)."""
    pk = _t(packed).requires_grad_()
    if fn is None:
        lists = peel_topk(pk, _t(cand), _t(pix), depth)
    else:
        lists = fn(pk, _t(cand), _t(pix), depth)
    rad, trans = composite_hits(lists[0], lists[1],
                                torch.stack(lists[2:], dim=-1))
    loss = (rad * _t(w_rad)).sum() + trans.sum()
    if w_layers is not None:
        for x, w in zip(lists, _t(w_layers)):
            loss = loss + torch.where(torch.isfinite(x), x * w, 0.0).sum()
    loss.backward()
    return pk.grad.numpy()


def _autograd_twin(pk, cand, pix, depth):
    layers, _ = peel_topk_torch(pk, cand, pix, depth)
    return layers.transpose(2, 3).unbind(1)


@pytest.mark.parametrize("case", ["binned", "gaps"])
def test_backward_matches_autograd_of_twin(peel_inputs, case):
    packed, cand, pix = peel_inputs
    cand = _edit(cand, case)
    rng = np.random.default_rng(4)
    shape = (cand.shape[0], pix.shape[1])
    w_rad = rng.standard_normal(shape + (3,)).astype(np.float32)
    w_layers = rng.standard_normal((5,) + shape + (16,)).astype(np.float32)
    got = _grad_topk(packed, cand, pix, 16, w_rad, w_layers)
    ref = _grad_topk(packed, cand, pix, 16, w_rad, w_layers,
                     fn=_autograd_twin)
    scale = np.abs(ref).max()
    assert scale > 0 and np.isfinite(got).all()
    # The sentinel row: vacant layers read it, so autograd of the twin
    # gives its color and SH lanes the vacant layers' rgb cotangents; the
    # hand-written backward, as the JAX rule, gives it none.
    np.testing.assert_allclose(got[:-1] / scale, ref[:-1] / scale, atol=1e-5)
    assert (got[-1] == 0).all()


def _j_via_topk(packed, cand, pix, depth, w_rad):
    """The JAX test's via_topk loss (test_peel_pallas.py:135-157)."""
    def loss(p):
        t1, a, r, g, b = peel_topk_pallas(p, cand, pix, depth)
        rad, trans = j_composite_hits(t1, a, jnp.stack([r, g, b], axis=-1))
        return jnp.sum(w_rad * rad) + jnp.sum(trans)

    return np.asarray(jax.grad(loss)(jnp.asarray(packed)))


def test_backward_matches_jax_pallas(small_inputs):
    packed, cand, pix = small_inputs
    w_rad = np.random.default_rng(3).standard_normal(
        (cand.shape[0], pix.shape[1], 3)).astype(np.float32)
    got = _grad_topk(packed, cand, pix, 8, w_rad)
    ref = _j_via_topk(packed, cand, pix, 8, w_rad)
    rel = np.abs(got - ref) / np.abs(ref).max()
    assert np.abs(got).max() > 0 and np.isfinite(got).all()
    assert rel.max() < 2e-3 and np.quantile(rel, 0.99) < 2e-4, (
        rel.max(), np.quantile(rel, 0.99))


def test_ties_go_to_the_lower_slot(peel_inputs):
    """Duplicated splats tie exactly in t1; the earlier candidate slot
    takes the nearer layer, and equal t1 sit in adjacent layers."""
    packed, cand, pix = peel_inputs
    (t1, *_), slots = _layers(packed, cand, pix, 16)
    slots = slots.numpy().transpose(0, 2, 1)                 # (T, P, K)
    tie = (t1[..., 1:] == t1[..., :-1]) & np.isfinite(t1[..., 1:])
    assert tie.any()
    assert (slots[..., :-1][tie] < slots[..., 1:][tie]).all()


def _opaque_fixture():
    """A hand-made tile whose 4 pixels all look down −z (A = 1 exactly)
    at three splats: the nearest has B = −4, c0 = 1, opacity 1, so its
    exponent B²/4A − (c0+3) is exactly 0 and α = 1; the two behind it
    have α = 0.5·e⁻¹ and 0.8·e⁻¹. Candidates padded to one chunk."""
    d = np.array([0.0, 0.0, -1.0])
    x, y, z = d
    c = [np.sqrt(3 / np.pi), np.sqrt(15 / np.pi), np.sqrt(5 / np.pi),
         np.sqrt(35 / (2 * np.pi)), np.sqrt(105 / np.pi),
         np.sqrt(21 / (2 * np.pi)), np.sqrt(7 / np.pi)]
    sh = [0.5 * c[0] * y, 0.5 * c[0] * z, 0.5 * c[0] * x,
          0.5 * c[1] * x * y, 0.5 * c[1] * y * z,
          0.25 * c[2] * (3 * z**2 - 1), 0.5 * c[1] * x * z,
          0.25 * c[1] * (x**2 - y**2), 0.25 * c[3] * y * (3 * x**2 - y**2),
          0.5 * c[4] * x * y * z, 0.25 * c[5] * y * (5 * z**2 - 1),
          0.25 * c[6] * (5 * z**2 - 3 * z), 0.25 * c[5] * x * (5 * z**2 - 1),
          0.25 * c[4] * (x**2 - y**2) * z,
          0.25 * c[3] * x * (x**2 - 3 * y**2)]
    row = np.concatenate([d, [0, 0, 0, 0, 0, 1.0], sh])
    pix = np.tile(row, (1, 4, 1)).astype(np.float32)           # (1, 4, 24)
    assert pix.shape[-1] == G_DIM
    packed = np.zeros((4, F_DIM), np.float32)
    packed[:, [0, 3, 5]] = 1.0                                 # M = I
    rng = np.random.default_rng(0)
    for i, (bz, c0, op) in enumerate([(-4.0, 1.0, 1.0), (-6.0, 7.0, 0.5),
                                      (-8.0, 14.0, 0.8)]):
        packed[i, 8] = -bz / 2                  # B = 2·d·Me = −2·Me_z
        packed[i, 9], packed[i, 10] = c0, op
        packed[i, 11:14] = rng.uniform(0.1, 0.9, 3)
        packed[i, 14:59] = 0.1 * rng.standard_normal(45)
    packed[3, 9] = 1e30                                        # sentinel
    cand = np.full((1, CHUNK), -1, np.int32)
    cand[0, :3] = [2, 0, 1]
    return packed, cand, pix


def test_opaque_layer_fixture():
    """α = 1 on the nearest layer (a zero factor in the transmittance):
    the forward, and the gradient through the hand-written backward,
    against autograd of the twin and jax.grad of the Pallas kernel."""
    packed, cand, pix = _opaque_fixture()
    (t1, alpha, *_), slots = _layers(packed, cand, pix, 4)
    np.testing.assert_array_equal(slots[0, :, 0].numpy(), [1, 2, 0, -1])
    assert (alpha[..., 0] == 1.0).all() and np.isinf(t1[..., 3]).all()
    np.testing.assert_allclose(alpha[0, 0, 1:3],
                               [0.5 * np.exp(-1), 0.8 * np.exp(-1)],
                               rtol=1e-6)
    w_rad = np.random.default_rng(1).standard_normal((1, 4, 3)).astype(
        np.float32)
    got = _grad_topk(packed, cand, pix, 4, w_rad)
    ref = _grad_topk(packed, cand, pix, 4, w_rad, fn=_autograd_twin)
    assert np.isfinite(got).all() and np.abs(got[:3]).max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, _j_via_topk(packed, cand, pix, 4, w_rad),
                               rtol=1e-4, atol=1e-5)
    # The layers behind the opaque one pass nothing on to the radiance.
    t1_, a, r, g, b = peel_topk(_t(packed), _t(cand), _t(pix), 4)
    rad, trans = composite_hits(t1_, a, torch.stack([r, g, b], dim=-1))
    assert (trans == 0).all()
    np.testing.assert_allclose(rad.numpy(),
                               np.stack([r[..., 0], g[..., 0], b[..., 0]],
                                        -1), rtol=1e-6)


def test_per_slot_gradients_and_cpu_dispatch(peel_inputs):
    """peel_topk_bwd_torch gives per-slot rows (T, C, 64) with losing
    slots and lanes 59:64 zero; peel_topk on CPU tensors runs the twins
    (``auto`` and ``torch`` alike); unknown impls raise, and ``cuda``
    refuses CPU tensors."""
    packed, cand, pix = map(_t, peel_inputs)
    layers, slots = peel_topk_torch(packed, cand, pix, 8)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (cand.shape[0], 4, 8, pix.shape[1])).astype(np.float32))
    d = peel_topk_bwd_torch(packed, cand, pix, slots, g)
    assert d.shape == (cand.shape[0], cand.shape[1], F_DIM)
    won = torch.zeros(cand.shape, dtype=torch.bool)
    for t in range(cand.shape[0]):
        won[t, slots[t][slots[t] >= 0].long()] = True
    assert (d[~won] == 0).all() and (d[..., 59:] == 0).all()
    assert (d[won].abs().sum(-1) > 0).any()
    auto = peel_topk(packed, cand, pix, 8)
    assert all(torch.equal(x, y) for x, y in zip(
        auto, peel_topk(packed, cand, pix, 8, impl="torch")))
    assert all(torch.equal(x, y) for x, y in zip(
        auto, layers.transpose(2, 3).unbind(1)))
    assert PeelTopK.apply(packed, cand, pix, 8, "torch").shape == (
        cand.shape[0], 5, 8, pix.shape[1])
    with pytest.raises(ValueError, match="unknown peel impl"):
        peel_topk(packed, cand, pix, 8, impl="pallas")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        peel_topk(packed, cand, pix, 8, impl="cuda")
