"""Batched quaternion math on torch tensors (scalar-last ``(x, y, z, w)``).

Port of :mod:`rtgs_tpu.utils.quaternion`: Hamilton product, scalar-last
storage, ``rot_vec3(q, v) = (q v q*).xyz``, and rotation matrices built by
rotating the three basis vectors (so a non-unit quaternion gives the same
scaled matrix as the reference). Every function broadcasts over leading axes.
"""

from __future__ import annotations

import numpy as np
import torch


def mul(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``p q`` for scalar-last quaternions."""
    pv, pw = p[..., :3], p[..., 3:4]
    qv, qw = q[..., :3], q[..., 3:4]
    w = pw * qw - torch.sum(pv * qv, dim=-1, keepdim=True)
    pv, qv = torch.broadcast_tensors(pv, qv)  # linalg.cross does not
    v = pw * qv + qw * pv + torch.linalg.cross(pv, qv, dim=-1)
    return torch.cat([v, w], dim=-1)


def conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def from_axis_angle(v: torch.Tensor) -> torch.Tensor:
    """Axis-angle vector (direction = axis, length = angle) → quaternion."""
    theta = torch.linalg.norm(v, dim=-1, keepdim=True)
    safe = torch.where(theta > 0, theta, torch.ones_like(theta))
    axis = torch.where(theta > 0, v / safe * torch.sin(theta / 2), v)
    return torch.cat([axis, torch.cos(theta / 2)], dim=-1)


def rot_vec3(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) ``v`` by quaternion(s) ``q`` as ``q v q*``."""
    qv = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
    return mul(q, mul(qv, conj(q)))[..., :3]


def as_rotation_mat3(q: torch.Tensor) -> torch.Tensor:
    """Quaternion → (..., 3, 3) rotation matrix with columns ``q eᵢ q*``
    (the rotated basis vectors)."""
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    shape = q.shape[:-1] + (3,)
    return torch.stack([rot_vec3(q, eye[i].expand(shape)) for i in range(3)],
                       dim=-1)


def from_rotation_matrix(m) -> torch.Tensor:
    """Rotation matrix → scalar-last unit quaternion (host side, Shepperd's
    method), returned as a float32 CPU tensor."""
    m = np.asarray(m, dtype=np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w])
    return torch.as_tensor(q / np.linalg.norm(q), dtype=torch.float32)
