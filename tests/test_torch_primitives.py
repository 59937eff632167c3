"""The port's primitive math against the JAX package on the same numpy
inputs: quaternions, Σ⁻¹ packing, AABBs, the SH basis, cameras,
the orbit pose, the pixel feature table and the packed feature table.

Tolerance rtol 1e-5, atol 1e-6: both are float32, with operations possibly
in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtgs_tpu import gaussians as JG
from rtgs_tpu import camera as JC
from rtgs_tpu.render import tiled as JT
from rtgs_tpu.utils import quaternion as JQ
from rtgs_tpu.viewer import orbit as JO
from rtgs_tpu_torch import camera as TC
from rtgs_tpu_torch import gaussians as TG
from rtgs_tpu_torch.bridge import (camera_from_numpy, camera_to_numpy,
                                   gaussians_from_numpy, gaussians_to_numpy)
from rtgs_tpu_torch.render import tiled as TT
from rtgs_tpu_torch.scene import random_scene_arrays
from rtgs_tpu_torch.utils import quaternion as TQ
from rtgs_tpu_torch.viewer import orbit as TO

RTOL, ATOL = 1e-5, 1e-6


def _close(port, ref):
    if isinstance(port, torch.Tensor):
        port = port.numpy()
    np.testing.assert_allclose(port, np.asarray(ref), rtol=RTOL, atol=ATOL)


def _both(x):
    return torch.from_numpy(x), jnp.asarray(x)


@pytest.fixture
def qv():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((64, 4)).astype(np.float32),
            rng.standard_normal((64, 4)).astype(np.float32),
            rng.standard_normal((64, 3)).astype(np.float32))


QUAT_OPS = {
    "mul": lambda Q, p, q, v: Q.mul(p, q),
    "conj": lambda Q, p, q, v: Q.conj(p),
    "normalize": lambda Q, p, q, v: Q.normalize(p),
    "from_axis_angle": lambda Q, p, q, v: Q.from_axis_angle(v),
    "rot_vec3": lambda Q, p, q, v: Q.rot_vec3(Q.normalize(p), v),
    "as_rotation_mat3": lambda Q, p, q, v: Q.as_rotation_mat3(p),
}


@pytest.mark.parametrize("op", sorted(QUAT_OPS))
def test_quaternion_ops(qv, op):
    tp, jp = _both(qv[0])
    tq, jq = _both(qv[1])
    tv, jv = _both(qv[2])
    fn = QUAT_OPS[op]
    _close(fn(TQ, tp, tq, tv), fn(JQ, jp, jq, jv))


def test_from_axis_angle_zero_angle():
    z = np.zeros((2, 3), np.float32)
    _close(TQ.from_axis_angle(torch.from_numpy(z)),
           JQ.from_axis_angle(jnp.asarray(z)))


def test_from_rotation_matrix(qv):
    for q in qv[0][:8]:
        m = np.asarray(JQ.as_rotation_mat3(JQ.normalize(jnp.asarray(q))))
        _close(TQ.from_rotation_matrix(m), JQ.from_rotation_matrix(m))


@pytest.fixture
def scene():
    return random_scene_arrays(256, 1.0, (0.02, 0.1), seed=1)


def test_inv_covariance_packed6(scene):
    tq, jq = _both(scene["quats"])
    ts, js = _both(scene["scales"])
    for a, b in zip(TG.inv_covariance_packed6(tq, ts),
                    JG.inv_covariance_packed6(jq, js)):
        _close(a, b)


def test_aabb(scene):
    tm, jm = _both(scene["means"])
    tq, jq = _both(scene["quats"])
    ts, js = _both(scene["scales"])
    for a, b in zip(TG.aabb(tm, tq, ts), JG.aabb(jm, jq, js)):
        _close(a, b)


def test_sh_basis():
    d = np.random.default_rng(2).standard_normal((128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    td, jd = _both(d)
    _close(TG.sh_basis(td), JG.sh_basis(jd))


def test_bridge_roundtrip(scene):
    g = gaussians_from_numpy(scene, device="cpu")
    back = gaussians_to_numpy(g)
    for f in TG.FIELDS:
        np.testing.assert_array_equal(back[f], scene[f])
    jcam = JC.camera_from_fov([0.0, 0.0, 3.0], [0.0, 0.0, 0.0, 1.0],
                              (40, 30), 50.0)
    cam = camera_to_numpy(camera_from_numpy(jcam, device="cpu"))
    assert cam["buf_size"] == (40, 30)
    for f in ("position", "rotation", "focal_length"):
        np.testing.assert_array_equal(cam[f], np.asarray(getattr(jcam, f)))


def _cameras():
    pos, rot, _, _ = JO.orbit_camera_pose(0.4, 1.1, 2.5, np.zeros(3),
                                          np.array([0.0, 0.0, 0.0, 1.0]))
    return (TC.camera_from_fov(pos, rot, (40, 24), 55.0, device="cpu"),
            JC.camera_from_fov(pos, rot, (40, 24), 55.0))


def test_camera_from_fov():
    t, j = _cameras()
    assert t.buf_size == j.buf_size
    for f in ("position", "rotation", "focal_length"):
        _close(getattr(t, f), getattr(j, f))


def test_image_to_display():
    img = np.random.default_rng(3).random((5, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        TC.image_to_display(torch.from_numpy(img)).numpy(),
        np.asarray(JC.image_to_display(jnp.asarray(img))))


@pytest.mark.parametrize("cursor,gq", [
    ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0)),
    ((0.1, -0.2, 0.3), (0.1, 0.2, -0.1, 0.97)),
])
def test_orbit_camera_pose(cursor, gq):
    args = (0.7, 1.3, 4.0, np.array(cursor), np.array(gq))
    for a, b in zip(TO.orbit_camera_pose(*args), JO.orbit_camera_pose(*args)):
        _close(np.asarray(a, np.float32), np.asarray(b, np.float32))


def test_orbit_state_transitions():
    t, j = TO.OrbitState(), JO.OrbitState()
    for s in (t, j):
        s.set_global_rotation(0.1, -0.2, 0.3)
        s.camera_pose()
        s.pan(0.2, -0.1)
        s.zoom(1.5)
        s.move_cursor(0.05, 0.02)
    _close(t.global_quat, j.global_quat)
    _close(t.cursor, j.cursor)
    for a, b in zip(t.camera_pose(), j.camera_pose()):
        _close(np.asarray(a, np.float32), np.asarray(b, np.float32))


@pytest.mark.parametrize("offset", [None, (0.3, -0.2)])
def test_tile_pixel_features(offset):
    t, j = _cameras()
    _close(TT._tile_pixel_features(t, (16, 16), offset),
           JT._tile_pixel_features(j, (16, 16), offset))


def test_precompute_and_pack_features(scene):
    t, j = _cameras()
    tg = gaussians_from_numpy(scene, device="cpu")
    jg = JG.Gaussians(**{k: jnp.asarray(v) for k, v in scene.items()})
    tf, jf = TT.precompute_features(tg, t), JT.precompute_features(jg, j)
    for f in ("opacity", "color", "sh"):
        _close(getattr(tf, f), getattr(jf, f))
    packed = TT.pack_features(tf)
    assert packed.shape == (257, 64) and packed[-1, 9] == 1e30
    jpacked = np.asarray(JT.pack_features(jf))
    _close(packed[:, 10:], jpacked[:, 10:])
    # Σ⁻¹, Me and c0: the port takes Σ⁻¹ from R·S⁻²·Rᵀ, the JAX package from
    # the adjugate of the assembled Σ, which loses ~cond(Σ)·2⁻²⁴ of each
    # splat's largest entry to cancellation (cond ≤ 25 at these scales);
    # the port's is the one nearer float64. Held per splat to 1e-5 of the
    # largest entry of each group of lanes.
    for lo, hi in ((0, 6), (6, 9), (9, 10)):
        got, ref = packed[:-1, lo:hi].numpy(), jpacked[:-1, lo:hi]
        scale = np.abs(ref).max(axis=1, keepdims=True)
        assert (np.abs(got - ref) / scale).max() <= 1e-5
    _close(packed[-1, :10], jpacked[-1, :10])          # the sentinel row
