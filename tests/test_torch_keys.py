"""The port's keys twin (rtgs_tpu_torch.ops.peel.peel_keys_torch) against
the JAX package's peel_keys_xla and its Pallas keys kernel
peel_keys_pallas (interpret mode on the CPU, as tests/test_keys_path.py
runs it), on the same packed table, candidates and pixel features.

32 splats are duplicated so that exact t1 ties exist: the tie rule (lower
splat id first) must hold in all three. Ids must be identical (the JAX
package's f32 +inf vacancy is −1 in the port) and vacancy patterns
identical. t1: the port evaluates the quadratic in float64 and the JAX
package in f32, whose error grows with the conditioning of Δ = B² − 4A·c0,
κ = |B|/√Δ; so t1 must agree within rtol max(1e-5, 8·2⁻²⁴·κ) per winner
(the JAX error measures ≤ 3·2⁻²⁴·κ on these inputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtgs_tpu import gaussians as JG
from rtgs_tpu.camera import camera_from_fov
from rtgs_tpu.ops.peel import CHUNK as J_CHUNK
from rtgs_tpu.ops.peel import peel_keys_pallas, peel_keys_xla
from rtgs_tpu.render.binning import tile_candidates
from rtgs_tpu.render.tiled import (_tile_pixel_features, pack_features,
                                   precompute_features)
from rtgs_tpu.viewer.orbit import orbit_camera_pose
from rtgs_tpu_torch.ops.peel import (CHUNK, _counts, peel_keys,
                                     peel_keys_torch)
from rtgs_tpu_torch.scene import random_scene_arrays


@pytest.fixture(scope="module")
def keys_inputs():
    fields = random_scene_arrays(300, 1.0, (0.02, 0.1), seed=5)
    fields = {k: np.concatenate([v, v[:32]]) for k, v in fields.items()}
    g = JG.Gaussians(**{k: jnp.asarray(v) for k, v in fields.items()})
    pos, rot, _, _ = orbit_camera_pose(0.3, 1.2, 3.0, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    cam = camera_from_fov(pos, rot, (32, 32), 60.0)
    b = tile_candidates(g, cam, tile=(16, 16), max_candidates=384,
                        max_global=32, chunk=J_CHUNK)
    packed = pack_features(precompute_features(g, cam))
    pix = _tile_pixel_features(cam, (16, 16))
    return packed, b.candidates, pix


def _port(x):
    return torch.from_numpy(np.array(x))


def _jax_kp(t1, sid):
    """JAX (T, P, K) f32 results → the port's (T, K, P), ids int32/−1."""
    t1, sid = np.asarray(t1), np.asarray(sid)
    sid = np.where(np.isfinite(sid), sid, -1).astype(np.int32)
    return t1.transpose(0, 2, 1), sid.transpose(0, 2, 1)


def _conditioning(packed, pix, sid):
    """κ = |B|/√Δ of each (T, K, P) winner, in float64."""
    rows = np.asarray(packed, np.float64)[np.where(sid >= 0, sid, 0)]
    q = np.asarray(pix, np.float64)[:, None, :, :]       # (T, 1, P, 24)
    a = np.sum(q[..., 3:9] * rows[..., 0:6], -1)
    b = 2.0 * np.sum(q[..., 0:3] * rows[..., 6:9], -1)
    delta = b * b - 4.0 * a * rows[..., 9]
    return np.abs(b) / np.sqrt(np.maximum(delta, 1e-300))


def _assert_keys_equal(out, ref, packed, pix):
    (t1, sid), (t1_ref, sid_ref) = (x.numpy() for x in out), ref
    assert t1.shape == t1_ref.shape and sid.dtype == np.int32
    np.testing.assert_array_equal(sid, sid_ref)
    fin = np.isfinite(t1_ref)
    assert (np.isfinite(t1) == fin).all()
    assert ((sid == -1) == ~fin).all()
    rtol = np.maximum(1e-5, 8 * 2.0**-24 * _conditioning(packed, pix, sid))
    err = np.abs(t1[fin] - t1_ref[fin]) / np.abs(t1_ref[fin])
    assert (err <= rtol[fin]).all(), (err / rtol[fin]).max()


@pytest.mark.parametrize("depth", [8, 16])
def test_twin_matches_xla(keys_inputs, depth):
    packed, cand, pix = keys_inputs
    ref = _jax_kp(*peel_keys_xla(packed, cand, pix, depth))
    out = peel_keys_torch(_port(packed), _port(cand), _port(pix), depth)
    _assert_keys_equal(out, ref, packed, pix)


def test_twin_matches_pallas_kernel(keys_inputs):
    packed, cand, pix = keys_inputs
    assert CHUNK == J_CHUNK
    ref = _jax_kp(*peel_keys_pallas(packed, cand, pix, 8))
    out = peel_keys_torch(_port(packed), _port(cand), _port(pix), 8)
    _assert_keys_equal(out, ref, packed, pix)
    # The duplicates make real ties: some pixel holds both copies.
    sid = out[1].numpy()
    n = packed.shape[0] - 1 - 32
    dup = (sid >= n)
    assert dup.any()
    twins = np.isin(sid - n, np.arange(32)) & dup
    assert twins.any()


def test_dispatch_on_cpu(keys_inputs):
    packed, cand, pix = map(_port, keys_inputs)
    ref = peel_keys_torch(packed, cand, pix, 8)
    for impl in ("auto", "torch"):
        out = peel_keys(packed, cand, pix, 8, impl=impl)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
    # The kernel never runs on CPU tensors: no silent fallback.
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        peel_keys(packed, cand, pix, 8, impl="cuda")
    with pytest.raises(ValueError, match="unknown keys impl"):
        peel_keys(packed, cand, pix, 8, impl="pallas")


def test_counts_is_last_valid_slot(keys_inputs):
    cand = _port(keys_inputs[1])
    c = _counts(cand).numpy()
    ref = np.asarray(keys_inputs[1] >= 0).sum(1)   # contiguous prefixes
    np.testing.assert_array_equal(c, ref)
    gap = torch.tensor([[3, -1, 5, -1], [-1, -1, -1, -1]], dtype=torch.int32)
    assert _counts(gap).tolist() == [3, 0]
