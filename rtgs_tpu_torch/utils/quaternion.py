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


def inv(q: torch.Tensor) -> torch.Tensor:
    """``conj(q) / |q|``: the reference divides by ``|q|``, not ``|q|²``,
    so this is the inverse of unit quaternions only (kept for parity)."""
    return conj(q) / torch.linalg.norm(q, dim=-1, keepdim=True)


def normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def from_axis_angle(v: torch.Tensor) -> torch.Tensor:
    """Axis-angle vector (direction = axis, length = angle) → quaternion."""
    theta = torch.linalg.norm(v, dim=-1, keepdim=True)
    safe = torch.where(theta > 0, theta, torch.ones_like(theta))
    axis = torch.where(theta > 0, v / safe * torch.sin(theta / 2), v)
    return torch.cat([axis, torch.cos(theta / 2)], dim=-1)


def as_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion → axis-angle vector (zero for the identity)."""
    theta = torch.arccos(torch.clamp(q[..., 3:4], -1.0, 1.0)) * 2
    xyz = q[..., :3]
    norm = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    return torch.where(norm > 0, xyz / safe * theta, torch.zeros_like(xyz))


def rot_vec3(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) ``v`` by quaternion(s) ``q`` as ``q v q*``."""
    qv = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
    return mul(q, mul(qv, conj(q)))[..., :3]


def rotation_columns(q: torch.Tensor):
    """The rotated basis vectors q eᵢ q* of (…, 4) quaternions, as
    ``cols[i][j]``: component j of column i, each a (…) tensor.
    :func:`rot_vec3`'s Hamilton products with their exact steps folded (q's
    own components and their negations), then ``(w·rⱼ + qᵢ·qⱼ) + (q_a·r_b −
    q_b·r_a)``, (a, b) = (j+1, j+2) mod 3, in that order, one elementwise
    operation at a time: the CUDA kernels (``binning.cu``, ``features.cu``)
    repeat it operation for operation, where a library's cross product or
    sum may fuse or reorder."""
    x, y, z, w = q.unbind(-1)
    v = (x, y, z)
    cols = []
    for i, r in enumerate(((w, z, -y), (-z, w, x), (y, -x, w))):
        cols.append(tuple(
            (w * r[j] + v[i] * v[j])
            + (v[(j + 1) % 3] * r[(j + 2) % 3]
               - v[(j + 2) % 3] * r[(j + 1) % 3])
            for j in range(3)))
    return cols


def as_rotation_mat3(q: torch.Tensor) -> torch.Tensor:
    """Quaternion → (..., 3, 3) rotation matrix with columns ``q eᵢ q*``
    (the rotated basis vectors)."""
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    shape = q.shape[:-1] + (3,)
    return torch.stack([rot_vec3(q, eye[i].expand(shape)) for i in range(3)],
                       dim=-1)


def as_rotation_mat4(q: torch.Tensor) -> torch.Tensor:
    """Quaternion → (..., 4, 4) homogeneous rotation matrix."""
    m4 = torch.zeros(q.shape[:-1] + (4, 4), dtype=q.dtype, device=q.device)
    m4[..., :3, :3] = as_rotation_mat3(q)
    m4[..., 3, 3] = 1.0
    return m4


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
