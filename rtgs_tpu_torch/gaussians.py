"""Gaussian primitive math on torch tensors.

Port of :mod:`rtgs_tpu.gaussians`, with its numerical contract:

  * ``Σ = R S Sᵀ Rᵀ`` with ``S = diag(scale)``; ``Σ⁻¹`` by adjugate and
    determinant, assembled from flat per-component arrays;
  * a ray hits the level-set ellipsoid ``xᵀ Σ⁻¹ x = 3``
    (:data:`BOUNDING_THRESHOLD`);
  * the AABB comes from the 6 endpoints ``μ ± 3·scaleᵢ·(R eᵢ)``;
  * color = base color + real SH of degrees 1..3, with the reference's
    ``5z² − 3z`` quirk in the Y₃₀ slot;
  * the response is ``ρ = exp(−dᵀ Σ⁻¹ d)``, with no ½.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rtgs_tpu_torch.utils import quaternion as quat
from rtgs_tpu_torch.utils.device import resolve_device

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


def new_gaussians(means, quats=None, scales=None, colors=None,
                  opacities=None, sh=None, mask=None,
                  device="cuda") -> Gaussians:
    """Constructor with the reference's defaults: identity rotation, unit
    scale, magenta color, opacity 1, zero SH, all live; on ``device``, the
    card unless the caller asks for the CPU."""
    device = resolve_device(device)

    def f32(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.float32)
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    means = f32(means)
    n = means.shape[0]

    def dflt(x, value, shape):
        return f32(value).expand(shape).clone() if x is None else f32(x)

    return Gaussians(
        means=means,
        quats=dflt(quats, [0.0, 0.0, 0.0, 1.0], (n, 4)),
        scales=dflt(scales, [1.0, 1.0, 1.0], (n, 3)),
        colors=dflt(colors, [1.0, 0.0, 1.0], (n, 3)),
        opacities=dflt(opacities, 1.0, (n,)),
        sh=dflt(sh, 0.0, (n, NUM_SH_COEFFS, 3)),
        mask=dflt(mask, 1.0, (n,)),
    )


def covariance(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``Σ = R S Sᵀ Rᵀ``. → (..., 3, 3)."""
    rs = quat.as_rotation_mat3(quats) * scales[..., None, :]  # R @ diag(s)
    return rs @ rs.transpose(-1, -2)


def _adjugate_inverse_3x3(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a 3×3 by adjugate and determinant (the reference's
    algorithm)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co00 = e * i - f * h
    co01 = -(d * i - f * g)
    co02 = d * h - e * g
    co10 = -(b * i - c * h)
    co11 = a * i - c * g
    co12 = -(a * h - b * g)
    co20 = b * f - c * e
    co21 = -(a * f - c * d)
    co22 = a * e - b * d
    det = a * co00 + b * co01 + c * co02
    adj = torch.stack([
        torch.stack([co00, co10, co20], dim=-1),
        torch.stack([co01, co11, co21], dim=-1),
        torch.stack([co02, co12, co22], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def inv_covariance(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``Σ⁻¹`` by adjugate of the assembled Σ. → (..., 3, 3)."""
    return _adjugate_inverse_3x3(covariance(quats, scales))


def inv_covariance_direct(quats: torch.Tensor,
                          scales: torch.Tensor) -> torch.Tensor:
    """``Σ⁻¹ = R S⁻² Rᵀ``: algebraically the same, better conditioned."""
    rs = quat.as_rotation_mat3(quats) / scales[..., None, :]
    return rs @ rs.transpose(-1, -2)


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m @ v`` for (..., 3, 3) and (..., 3) operands that broadcast,
    summed over j = 0, 1, 2 elementwise in f32: a batched matmul would
    expand ``m`` to the broadcast shape."""
    return (m[..., 0] * v[..., 0:1] + m[..., 1] * v[..., 1:2]
            + m[..., 2] * v[..., 2:3])


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


def inv_covariance_direct6(quats: torch.Tensor, scales: torch.Tensor):
    """``Σ⁻¹`` entries ``(m00, m01, m02, m11, m12, m22)`` in the direct form
    ``R S⁻² Rᵀ``, in flat per-component arrays. The rotated basis vectors
    ``c_k = q e_k q*`` are ``|q|²`` long, so ``Σ = C S² Cᵀ`` and its exact
    inverse is ``Σ_k a_k a_kᵀ`` with ``a_k = c_k / (|q|⁴ s_k)``: the same
    function of ``quats`` and ``scales`` as :func:`inv_covariance_packed6`
    (the reference's adjugate of the assembled Σ), gradients included. Each
    diagonal entry is a sum of squares and each entry is off by a few ulps
    of ``1/s_min²``, so the matrix keeps its definiteness where the adjugate
    cancels: at a scale ratio of 100 within a splat that one comes out
    indefinite.

    Written out one elementwise operation at a time (the rotation columns
    of :func:`~rtgs_tpu_torch.utils.quaternion.rotation_columns`, |q|² as a
    left-to-right sum), so that the feature-table kernel
    (``ops/csrc/features.cu``) repeats it bit for bit."""
    mx, my, mz = quat.rotation_columns(quats)
    x, y, z, w = quats.unbind(-1)
    qq = ((x * x + y * y) + z * z) + w * w
    inv_n2 = torch.reciprocal(qq * qq)
    ix, iy, iz = (inv_n2 / scales[..., 0], inv_n2 / scales[..., 1],
                  inv_n2 / scales[..., 2])
    ux, uy, uz = mx[0] * ix, mx[1] * ix, mx[2] * ix
    vx, vy, vz = my[0] * iy, my[1] * iy, my[2] * iy
    wx, wy, wz = mz[0] * iz, mz[1] * iz, mz[2] * iz
    m00 = ux * ux + vx * vx + wx * wx
    m01 = ux * uy + vx * vy + wx * wy
    m02 = ux * uz + vx * vz + wx * wz
    m11 = uy * uy + vy * vy + wy * wy
    m12 = uy * uz + vy * vz + wy * wz
    m22 = uz * uz + vz * vz + wz * wz
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
    → (..., 15). Each term one elementwise operation at a time, the squares
    as products and each constant a Python float (rounded to f32 once):
    the pixel-table kernel (``ops/csrc/features.cu``) repeats them bit for
    bit."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    x2_y2 = xx - yy
    z5_1 = 5 * zz - 1
    return torch.stack(
        [
            0.5 * C_0 * y,
            0.5 * C_0 * z,
            0.5 * C_0 * x,
            0.5 * C_1 * x * y,
            0.5 * C_1 * y * z,
            0.25 * C_2 * (3 * zz - 1),
            0.5 * C_1 * x * z,
            0.25 * C_1 * x2_y2,
            0.25 * C_3 * y * (3 * xx - yy),
            0.5 * C_4 * x * y * z,
            0.25 * C_5 * y * z5_1,
            # Reference quirk kept verbatim: 5z² − 3z where the textbook
            # Y₃₀ has 5z³ − 3z.
            0.25 * C_6 * (5 * zz - 3 * z),
            0.25 * C_5 * x * z5_1,
            0.25 * C_4 * x2_y2 * z,
            0.25 * C_3 * x * (xx - 3 * yy),
        ],
        dim=-1,
    )


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH radiance ``Σₖ yₖ(dir) · shₖ``. ``sh``: (..., 15, 3); ``dirs``:
    (..., 3) unit. → (..., 3)."""
    return torch.sum(sh_basis(dirs)[..., None] * sh, dim=-2)


def hit(cov_inv: torch.Tensor, means: torch.Tensor, origins: torch.Tensor,
        directions: torch.Tensor):
    """Ray–Gaussian intersection against ``xᵀΣ⁻¹x = 3``; all arguments
    broadcast. Returns ``(t1, t2)`` ascending, with the reference's miss
    semantics: ``Δ < 0 → (inf, inf)``, ``Δ == 0 → (−B/2A, inf)``.

    Every branch that ``torch.where`` does not take still back-propagates
    zeros through its operations, so the square root reads
    ``where(Δ > 0, Δ, 1)``: an inf or NaN there would turn those zeros
    into NaN."""
    e = origins - means
    me = _matvec(cov_inv, e)
    md = _matvec(cov_inv, directions)
    a = torch.sum(directions * md, dim=-1)
    b = 2.0 * torch.sum(directions * me, dim=-1)
    c = torch.sum(e * me, dim=-1) - BOUNDING_THRESHOLD
    delta = b * b - 4 * a * c
    sq = torch.sqrt(torch.where(delta > 0, delta, 1.0))  # grad-safe sqrt
    t1 = torch.where(delta > 0, (-b - sq) / (2 * a),
                     torch.where(delta == 0, -b / (2 * a), math.inf))
    t2 = torch.where(delta > 0, (-b + sq) / (2 * a), math.inf)
    return t1, t2


def eval_gaussian(cov_inv: torch.Tensor, means: torch.Tensor,
                  colors: torch.Tensor, opacities: torch.Tensor,
                  sh: torch.Tensor, pos: torch.Tensor, dirs: torch.Tensor):
    """The reference's ``Gaussian.eval``: the unnormalized response at
    ``pos`` and the SH color for view direction ``dirs``. Returns
    ``(rgb, alpha)``."""
    d = pos - means
    rho = torch.exp(-torch.sum(d * _matvec(cov_inv, d), dim=-1))
    dirs_n = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return colors + eval_sh(sh, dirs_n), opacities * rho
