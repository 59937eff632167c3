"""Orbit-camera controller (port of :mod:`rtgs_tpu.viewer.orbit`): a
spherical ``(theta, phi, r)`` orbit around a movable 3D cursor, composed
with a global scene rotation quaternion. Host-side numpy plus the port's
quaternions."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rtgs_tpu_torch.utils import quaternion as quat


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


@dataclasses.dataclass
class OrbitState:
    """Viewer camera state."""

    theta: float = 0.0
    phi: float = math.pi / 2
    r: float = 1.0
    cursor: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    # Global scene rotation (scalar-last).
    global_quat: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, 0.0, 1.0]))
    cam_right: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 0.0, 0.0]))
    cam_up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, 1.0]))

    pan_sensitivity: float = 2.0
    scroll_sensitivity: float = 0.1
    move_sensitivity: float = 2.0

    def pan(self, dx: float, dy: float) -> None:
        """Drag in normalized screen units: orbit, with phi clamped to
        [0, π]."""
        self.theta -= dx * self.pan_sensitivity
        self.phi += dy * self.pan_sensitivity
        self.phi = max(0.0, min(self.phi, math.pi))

    def zoom(self, wheel_delta: float) -> None:
        self.r += self.scroll_sensitivity * self.r * wheel_delta

    def move_cursor(self, dx: float, dy: float) -> None:
        """Move the 3D cursor in the camera plane."""
        self.cursor = update_cursor(
            self.cursor, dx * self.r * self.move_sensitivity,
            dy * self.r * self.move_sensitivity,
            self.cam_right, self.cam_up)

    def set_global_rotation(self, rx: float, ry: float, rz: float) -> None:
        """``global = qz · qy · qx`` from three axis angles."""
        qx, qy, qz = (quat.from_axis_angle(_f32(v)) for v in
                      ([rx, 0.0, 0.0], [0.0, ry, 0.0], [0.0, 0.0, rz]))
        self.global_quat = quat.mul(qz, quat.mul(qy, qx)).numpy()

    def camera_pose(self):
        """Current (position, rotation_quat) for the renderer."""
        pos, rot, right, up = orbit_camera_pose(
            self.theta, self.phi, self.r, self.cursor, self.global_quat)
        self.cam_right, self.cam_up = right, up
        return pos, rot


def update_cursor(cursor, u, v, cam_right, cam_up):
    """``cursor − u·cam_right − v·cam_up``."""
    return (np.asarray(cursor) - u * np.asarray(cam_right)
            - v * np.asarray(cam_up))


def orbit_camera_pose(theta, phi, r, cursor, global_quat):
    """Camera on the z-up sphere at ``(θ, φ, r)`` looking at the origin,
    offset by the cursor, then the whole pose rotated by ``global_quat``.

    Returns (position (3,), rotation quat scalar-last (4,), cam_right,
    cam_up) as numpy arrays."""
    pos = np.array([
        r * math.cos(theta) * math.sin(phi),
        r * math.sin(theta) * math.sin(phi),
        r * math.cos(phi),
    ])
    look = -pos / np.linalg.norm(pos)
    cam_right = np.array([-math.sin(theta), math.cos(theta), 0.0])
    cam_up = np.cross(cam_right, look)
    # Columns are the camera basis vectors (the camera looks down −z).
    rot_mat = np.stack([cam_right, cam_up, -look], axis=1)
    q = quat.from_rotation_matrix(rot_mat)
    gq = _f32(global_quat)
    q_world = quat.mul(gq, q).numpy()
    gmat = quat.as_rotation_mat3(gq).numpy()
    pos_world = gmat @ (pos + np.asarray(cursor))
    return pos_world, q_world, cam_right, cam_up
