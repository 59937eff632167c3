"""Gaussian primitive math on torch tensors.

Port of :mod:`rtgs_tpu.gaussians`, with its numerical contract:

  * ``Σ = R S Sᵀ Rᵀ`` with ``S = diag(scale)``; ``Σ⁻¹`` by adjugate and
    determinant, assembled from flat per-component arrays;
  * a ray hits the level-set ellipsoid ``xᵀ Σ⁻¹ x = 3``
    (:data:`BOUNDING_THRESHOLD`);
  * the AABB comes from the 6 endpoints ``μ ± 3·scaleᵢ·(R eᵢ)``;
  * color = base color + real SH of degrees 1..3, with the reference's
    ``5z² − 3z`` quirk in the Y₃₀ slot.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rtgs_tpu_torch.utils import quaternion as quat

BOUNDING_THRESHOLD = 3.0

C_0 = math.sqrt(3 / math.pi)
C_1 = math.sqrt(15 / math.pi)
C_2 = math.sqrt(5 / math.pi)
C_3 = math.sqrt(35 / (2 * math.pi))
C_4 = math.sqrt(105 / math.pi)
C_5 = math.sqrt(21 / (2 * math.pi))
C_6 = math.sqrt(7 / math.pi)

NUM_SH_COEFFS = 15  # degrees 1..3 → 3 + 5 + 7

FIELDS = ("means", "quats", "scales", "colors", "opacities", "sh", "mask")


@dataclasses.dataclass
class Gaussians:
    """Structure-of-arrays Gaussian scene; every field lies on one device.

    Attributes:
      means:     (N, 3)  centers.
      quats:     (N, 4)  rotations, scalar-last ``(x, y, z, w)``.
      scales:    (N, 3)  per-axis standard deviations (post-activation).
      colors:    (N, 3)  base RGB (post-sigmoid).
      opacities: (N,)    opacity in [0, 1] (post-sigmoid).
      sh:        (N, 15, 3)  SH coefficients, degree-major, RGB innermost.
      mask:      (N,)    1.0 live, 0.0 padding (never hits).
    """

    means: torch.Tensor
    quats: torch.Tensor
    scales: torch.Tensor
    colors: torch.Tensor
    opacities: torch.Tensor
    sh: torch.Tensor
    mask: torch.Tensor

    @property
    def num(self) -> int:
        return self.means.shape[0]

    @property
    def device(self) -> torch.device:
        return self.means.device


def _rotation_columns(quats: torch.Tensor):
    """The three rotated basis vectors (columns of R), each (..., 3)."""
    return quat.as_rotation_mat3(quats).unbind(-1)


def inv_covariance_packed6(quats: torch.Tensor, scales: torch.Tensor):
    """``Σ⁻¹`` entries ``(m00, m01, m02, m11, m12, m22)``: assemble
    ``Σ = u uᵀ + v vᵀ + w wᵀ`` from the scaled rotation columns and invert
    it by adjugate and determinant, in flat per-component arrays."""
    mx, my, mz = _rotation_columns(quats)
    sx, sy, sz = scales[..., 0], scales[..., 1], scales[..., 2]
    ux, uy, uz = mx[..., 0] * sx, mx[..., 1] * sx, mx[..., 2] * sx
    vx, vy, vz = my[..., 0] * sy, my[..., 1] * sy, my[..., 2] * sy
    wx, wy, wz = mz[..., 0] * sz, mz[..., 1] * sz, mz[..., 2] * sz
    s00 = ux * ux + vx * vx + wx * wx
    s01 = ux * uy + vx * vy + wx * wy
    s02 = ux * uz + vx * vz + wx * wz
    s11 = uy * uy + vy * vy + wy * wy
    s12 = uy * uz + vy * vz + wy * wz
    s22 = uz * uz + vz * vz + wz * wz
    co00 = s11 * s22 - s12 * s12
    co01 = -(s01 * s22 - s12 * s02)
    co02 = s01 * s12 - s11 * s02
    det = s00 * co00 + s01 * co01 + s02 * co02
    m00 = co00 / det
    m01 = co01 / det
    m02 = co02 / det
    m11 = (s00 * s22 - s02 * s02) / det
    m12 = -(s00 * s12 - s01 * s02) / det
    m22 = (s00 * s11 - s01 * s01) / det
    return m00, m01, m02, m11, m12, m22


def aabb(means: torch.Tensor, quats: torch.Tensor, scales: torch.Tensor):
    """Axis-aligned bounds ``(p_min, p_max)`` from the principal-axis
    endpoints ``μ ± 3·scaleᵢ·(R eᵢ)``."""
    mx, my, mz = _rotation_columns(quats)
    ext = torch.maximum(
        torch.maximum(torch.abs(mx * scales[..., 0:1]),
                      torch.abs(my * scales[..., 1:2])),
        torch.abs(mz * scales[..., 2:3])) * BOUNDING_THRESHOLD
    return means - ext, means + ext


def sh_basis(dirs: torch.Tensor) -> torch.Tensor:
    """The reference's real SH basis, degrees 1..3, at unit directions.
    → (..., 15)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    return torch.stack(
        [
            0.5 * C_0 * y,
            0.5 * C_0 * z,
            0.5 * C_0 * x,
            0.5 * C_1 * x * y,
            0.5 * C_1 * y * z,
            0.25 * C_2 * (3 * z**2 - 1),
            0.5 * C_1 * x * z,
            0.25 * C_1 * (x**2 - y**2),
            0.25 * C_3 * y * (3 * x**2 - y**2),
            0.5 * C_4 * x * y * z,
            0.25 * C_5 * y * (5 * z**2 - 1),
            # Reference quirk kept verbatim: 5z² − 3z where the textbook
            # Y₃₀ has 5z³ − 3z.
            0.25 * C_6 * (5 * z**2 - 3 * z),
            0.25 * C_5 * x * (5 * z**2 - 1),
            0.25 * C_4 * (x**2 - y**2) * z,
            0.25 * C_3 * x * (x**2 - 3 * y**2),
        ],
        dim=-1,
    )
