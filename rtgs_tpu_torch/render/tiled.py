"""Tile-binned renderers: the keys path (port of
:func:`rtgs_tpu.render.tiled.render_tiled_keys`, differentiable through
the hand-written backward of :func:`shade_winners_kp`), the fused-payload
path (:func:`render_tiled_pallas`, differentiable, under the JAX name), and the
per-tile argmin peel (:func:`render_tiled`, differentiable through torch
autograd, with no kernel: it is plain XLA in the JAX package too).

Per frame:

  1. :func:`~rtgs_tpu_torch.render.binning.tile_candidates` — depth-ordered
     candidate lists per 16×16 tile, with per-chunk entry-depth bounds;
  2. :func:`precompute_features` + :func:`pack_features` — fold the camera
     position into each Gaussian once, into the (N+1, 64) table: with
     ``e = origin − μ`` and ``M = Σ⁻¹``, every (pixel, candidate) quadratic
     is ``A = dᵀMd``, ``B = 2dᵀ(Me)``, ``c0 = eᵀMe − 3``; and
     :func:`_tile_pixel_features` — the (T, P, 24) pixel table. On the card
     each table is one hand-written kernel (``ops/csrc/features.cu``), the
     feature table only where autograd records nothing; elsewhere the plain
     chains (:func:`precompute_features_torch`, :func:`pixel_table_torch`),
     which the kernels equal bit for bit;
  3. :func:`~rtgs_tpu_torch.ops.peel.peel_keys` — per pixel, the K nearest
     (t1, splat id) pairs (the Hopper keys kernel on the card);
  4. :func:`shade_winners_kp` — α and rgb of the K winners, with the
     reference's chord-midpoint response ``ρ = exp(B²/4A − (c0+3))``;
  5. :func:`composite_layers_kp` — front-to-back composite.

The fused-payload path replaces stages 3-5 with one
:func:`~rtgs_tpu_torch.ops.peel.peel_fused` call per band (the Hopper
forward and backward kernels on the card), which selects by (t1, candidate
slot), shades and composites in one pass. :func:`render_tiled` replaces
them with :func:`intersect_candidates` (every pixel against every
candidate of its tile) and :func:`peel_block` (K masked-argmin steps),
over chunks of tiles. All three take t1 from the float64 chain of
:func:`~rtgs_tpu_torch.ops.peel.entry_depth` and order by (t1, candidate
slot), so they select the same winners.

Layouts follow the JAX package: tile index ``T = tx·nty + ty``, pixels in
local (x, y) raster order, images (W, H, 3) with a bottom-left origin.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.camera import Camera
from rtgs_tpu_torch.ops._launch import Launcher, check_tensors
from rtgs_tpu_torch.ops.peel import (CHUNK, F_DIM, G_DIM, entry_depth,
                                     peel_fused, peel_keys, segment_rows)
from rtgs_tpu_torch.render.binning import tile_candidates
from rtgs_tpu_torch.utils import profiling
from rtgs_tpu_torch.utils import quaternion as quat
from rtgs_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class TileFeatures:
    """Per-Gaussian camera-folded features, with one sentinel row appended
    (index N never hits)."""

    m6: torch.Tensor       # (N+1, 6)  Σ⁻¹ packed [m00,m01,m02,m11,m12,m22]
    me: torch.Tensor       # (N+1, 3)  Σ⁻¹ (origin − μ)
    c0: torch.Tensor       # (N+1,)    eᵀΣ⁻¹e − 3
    opacity: torch.Tensor  # (N+1,)
    color: torch.Tensor    # (N+1, 3)
    sh: torch.Tensor       # (N+1, 15, 3)
    # The (N+1, 64) table when the kernel wrote it (the other fields but c0
    # are views of it, and pack_features returns it); None on the chain.
    packed: torch.Tensor | None = None


FEATURE_FIELDS = ("m6", "me", "c0", "opacity", "color", "sh")


def precompute_features_torch(g: G.Gaussians,
                              camera: Camera) -> TileFeatures:
    """Fold the camera position into each Gaussian: the plain chain,
    differentiable through torch autograd. Σ⁻¹ comes from the direct form
    R·S⁻²·Rᵀ
    (:func:`~rtgs_tpu_torch.gaussians.inv_covariance_direct6`),
    not from the JAX package's adjugate of the assembled Σ: the two agree to
    ~cond(Σ)·2⁻²⁴ on well-conditioned splats, and on needles and discs only
    the direct form stays positive definite, which the binning's entry-depth
    bound relies on (:func:`entry_lower_bound`)."""
    m00, m01, m02, m11, m12, m22 = G.inv_covariance_direct6(g.quats,
                                                            g.scales)
    m6 = torch.stack([m00, m01, m02, m11, m12, m22], dim=-1)
    e = camera.position[None, :] - g.means
    ex, ey, ez = e[:, 0], e[:, 1], e[:, 2]
    mex = m00 * ex + m01 * ey + m02 * ez
    mey = m01 * ex + m11 * ey + m12 * ez
    mez = m02 * ex + m12 * ey + m22 * ez
    me = torch.stack([mex, mey, mez], dim=-1)
    c0 = (ex * mex + ey * mey + ez * mez) - G.BOUNDING_THRESHOLD

    def sentinel(x, row):
        row = torch.as_tensor(row, dtype=x.dtype).to(x.device)
        return torch.cat([x, row.reshape((1,) + x.shape[1:])], dim=0)

    return TileFeatures(
        m6=sentinel(m6, [1.0, 0.0, 0.0, 1.0, 0.0, 1.0]),
        me=sentinel(me, [0.0, 0.0, 0.0]),
        c0=sentinel(c0, math.inf),
        opacity=sentinel(g.opacities, 0.0),
        color=sentinel(g.colors, [0.0, 0.0, 0.0]),
        sh=sentinel(g.sh, torch.zeros((15, 3))),
    )


_TABLE = Launcher("rtgs_features_table", "feature table")
_PIXELS = Launcher("rtgs_features_pixels", "pixel table")


def feature_table_cuda(g: G.Gaussians, camera: Camera):
    """The (N+1, 64) table of :func:`pack_features` and the (N+1,) c0 of
    :class:`TileFeatures` (inf in the sentinel row, where the table holds
    1e30), from one launch of ``csrc/features.cu``'s table kernel on the
    current stream: bitwise ``pack_features(precompute_features_torch(g,
    camera))`` and its ``c0``. No gradient flows through it. Every input
    must be a CUDA tensor on one device (else ``ValueError``); a failed
    build or launch raises. ``feature_table_cuda.launches`` counts the
    calls."""
    n = g.num
    f32 = torch.float32
    ins = (("means", g.means, (n, 3)), ("quats", g.quats, (n, 4)),
           ("scales", g.scales, (n, 3)), ("colors", g.colors, (n, 3)),
           ("opacities", g.opacities, (n,)),
           ("sh", g.sh, (n, G.NUM_SH_COEFFS, 3)),
           ("position", camera.position, (3,)))
    specs = [(name, x.detach().contiguous(), f32, shape)
             for name, x, shape in ins]
    dev = check_tensors("feature_table_cuda", specs)
    packed = torch.empty((n + 1, F_DIM), dtype=f32, device=dev)
    c0 = torch.empty((n + 1,), dtype=f32, device=dev)
    _TABLE(dev, *(x.data_ptr() for _, x, _, _ in specs), packed.data_ptr(),
           c0.data_ptr(), n)
    feature_table_cuda.launches += 1
    return packed, c0


feature_table_cuda.launches = 0


def _records_grad(g: G.Gaussians, camera: Camera) -> bool:
    """Whether autograd would record the table: grad mode on and a field
    the table reads requiring grad."""
    return torch.is_grad_enabled() and any(
        x.requires_grad for x in (g.means, g.quats, g.scales, g.colors,
                                  g.opacities, g.sh, camera.position))


def precompute_features(g: G.Gaussians, camera: Camera) -> TileFeatures:
    """Fold the camera position into each Gaussian, with one sentinel row.

    On the card, where autograd records nothing (grad mode off, or no field
    requiring grad), one launch of the table kernel
    (:func:`feature_table_cuda`) writes the (N+1, 64) table, which the
    result carries (its fields are views of it, but ``c0``); it launches or
    raises. Elsewhere the plain chain (:func:`precompute_features_torch`):
    on the CPU, and on the card while autograd records (the fit's training
    step), where the chain is the table's differentiable definition, not a
    fallback. The two give the same bits on the card. A profiled window
    counts the kernel's tables (``features.kernel_tables``)."""
    if g.device.type != "cuda" or _records_grad(g, camera):
        return precompute_features_torch(g, camera)
    packed, c0 = feature_table_cuda(g, camera)
    profiling.count("features.kernel_tables", 1)
    return table_features(packed, c0)


def table_features(packed: torch.Tensor, c0: torch.Tensor) -> TileFeatures:
    """The :class:`TileFeatures` of an (N+1, 64) table (lane map in
    :mod:`rtgs_tpu_torch.ops.peel`), its fields views of it, and of its
    (N+1,) ``c0`` with the inf sentinel."""
    return TileFeatures(
        m6=packed[:, 0:6], me=packed[:, 6:9], c0=c0, opacity=packed[:, 10],
        color=packed[:, 11:14],
        sh=packed[:, 14:59].unflatten(1, (3, 15)).transpose(1, 2),
        packed=packed)


def entry_lower_bound(g: G.Gaussians, camera: Camera,
                      packed: torch.Tensor) -> torch.Tensor:
    """Per splat, a proven lower bound (N,) f32 of every entry depth t1
    that the float64 chain (:func:`~rtgs_tpu_torch.ops.peel.entry_depth`)
    can give from the f32 table ``packed`` along any pixel's ray: what
    ``tile_candidates(..., entry_lb=...)`` builds ``chunk_lb`` from.

    The binning's own bound, depth − √3·s_max, holds for the exact
    ellipsoid; the table is rounded to f32, and its c0 alone is off by up to
    2⁻²⁴·|e|²/s_min², which moves the surface. Derivation, with M, v = Me
    and c0 evaluated in float64 from the scene (exact to 2⁻⁵³) and δM, δv,
    δc0 the table's differences from them, measured here, not estimated.
    Along a ray x = e + t·d the chain solves Â t² + B̂ t + ĉ0 = 0 with the
    table's coefficients, while xᵀMx − 3 = A t² + B t + c0. At its root t̂,
    with E = |e| and t̂·|d| < E (otherwise t̂ ≥ E/|d| ≥ depth/|d| and there
    is nothing to prove), the point x̂ = e + t̂·d has
        |x̂ᵀMx̂ − 3| ≤ |Â − A|·t̂² + |B̂ − B|·t̂ + |ĉ0 − c0| + r ≤ η,
        η = 3·(max|δM| + 2⁻²⁴·max|M|)·E² + 2·‖δv‖₂·E + |δc0| + r,
    because Σ|fd_j| = (|d_x| + |d_y| + |d_z|)² ≤ 3|d|², the pixel table's
    fd is d's products rounded once (the 2⁻²⁴·max|M| term), and the
    float64 chain leaves a residual r ≤ 2⁻⁴⁵·(|ĉ0| + 3) at its root (Δ/4A
    ≤ 3 and the cancelling terms are below |ĉ0| + 3). So x̂ lies on or
    inside the ellipsoid scaled by √(1 + η/3), within √(3 + η)·s_max of the
    mean, and its depth along the optical axis, which is t̂·(d·f) ≤ t̂·|d|, is
    at least depth − √(3 + η)·s_max. Rotations enter through their
    unnormalised quaternions as everywhere in the port: a splat's axes are
    n = |q|² times its scales long, which multiplies the reach, and |d| ≤
    n_cam·(1 + 2⁻²⁰). The result is rounded towards zero into f32 and
    clamped at 0; a row that is not finite gets 0 (no bound)."""
    f64 = torch.float64
    with torch.no_grad():
        quats, scales = g.quats.detach().to(f64), g.scales.detach().to(f64)
        n = quats.shape[0]
        # The rotated basis vectors q eₖ q* (columns, |q|² long) from the
        # quaternions' products: one matrix product, not dozens of passes.
        qq = (quats[:, :, None] * quats[:, None, :]).reshape(n, 16)
        cols = (qq @ _quat_to_mat3(qq.device)).reshape(n, 3, 3)
        norm2 = (quats * quats).sum(-1)                    # |q|²
        a = cols / (scales * (norm2 * norm2)[:, None])[:, None, :]
        m = (a[:, :, None, :] * a[:, None, :, :]).sum(-1)  # (N, 3, 3)
        e = (camera.position.to(f64)[None, :] - g.means.detach().to(f64))
        v = (m * e[:, None, :]).sum(-1)
        c0 = (e * v).sum(-1) - G.BOUNDING_THRESHOLD
        m6 = m.reshape(n, 9)[:, _SYM6]
        tab = packed.detach()[:-1, :10].to(f64)
        d_m = (tab[:, :6] - m6).abs().amax(-1)
        d_v = torch.linalg.norm(tab[:, 6:9] - v, dim=-1)
        d_c0 = (tab[:, 9] - c0).abs()
        dist = torch.linalg.norm(e, dim=-1)
        eta = 1.001 * (3.0 * (d_m + 2.0**-24 * m6.abs().amax(-1)) * dist**2
                       + 2.0 * d_v * dist + d_c0
                       + 2.0**-45 * (tab[:, 9].abs() + 3.0))
        reach = (torch.sqrt(G.BOUNDING_THRESHOLD + eta) * scales.amax(-1)
                 * norm2)
        cam_q = camera.rotation.to(f64)
        n_cam = (cam_q * cam_q).sum()
        # The optical axis: the camera looks down its −z, the third column.
        axis = -((cam_q[:, None] * cam_q[None, :]).reshape(1, 16)
                 @ _quat_to_mat3(cam_q.device)).reshape(3, 3)[:, 2]
        depth = -(e * axis).sum(-1) / n_cam
        lb = ((depth - reach).clamp(min=0.0)
              / (n_cam * (1.0 + 2.0**-20)) * (1.0 - 2.0**-20))
        lb32 = torch.nan_to_num(lb, nan=0.0, posinf=0.0).float()
        return torch.where(lb32.double() > lb,
                           torch.nextafter(lb32, torch.zeros_like(lb32)),
                           lb32)


@functools.lru_cache(maxsize=None)
def _quat_to_mat3(device: torch.device) -> torch.Tensor:
    """(16, 9) float64 on ``device``: the row-major 3×3 matrix with columns
    q eₖ q* as a linear map of the products q_a·q_b (a, b over x, y, z, w;
    row 4a + b)."""
    x, y, z, w = range(4)
    terms = {   # entry → ((a, b), coefficient) ...
        0: (((w, w), 1), ((x, x), 1), ((y, y), -1), ((z, z), -1)),
        1: (((x, y), 2), ((w, z), -2)),
        2: (((x, z), 2), ((w, y), 2)),
        3: (((x, y), 2), ((w, z), 2)),
        4: (((w, w), 1), ((x, x), -1), ((y, y), 1), ((z, z), -1)),
        5: (((y, z), 2), ((w, x), -2)),
        6: (((x, z), 2), ((w, y), -2)),
        7: (((y, z), 2), ((w, x), 2)),
        8: (((w, w), 1), ((x, x), -1), ((y, y), -1), ((z, z), 1)),
    }
    out = torch.zeros((16, 9), dtype=torch.float64)
    for entry, parts in terms.items():
        for (a, b), coeff in parts:
            out[4 * a + b, entry] = coeff
    return out.to(device)


_SYM6 = [0, 1, 2, 4, 5, 8]   # the packed sym6 lanes of a row-major 3×3


def direction_features(dirs: torch.Tensor):
    """Per-pixel d-quadratic features (matching the ``m6`` packing) and the
    SH basis, for unit ``dirs``."""
    dx, dy, dz = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    fd = torch.stack([dx * dx, 2 * dx * dy, 2 * dx * dz, dy * dy,
                      2 * dy * dz, dz * dz], dim=-1)
    return fd, G.sh_basis(dirs)


def pack_features(feats: TileFeatures) -> torch.Tensor:
    """TileFeatures → the (N+1, 64) table (lane map in
    :mod:`rtgs_tpu_torch.ops.peel`). The sentinel's c0 becomes 1e30: finite,
    so Δ < 0 there with no inf arithmetic. A table the kernel wrote is
    returned as it is, with no copy."""
    if feats.packed is not None:
        return feats.packed
    n1 = feats.c0.shape[0]
    sh = feats.sh
    packed = torch.cat([
        feats.m6, feats.me, feats.c0[:, None], feats.opacity[:, None],
        feats.color, sh[:, :, 0], sh[:, :, 1], sh[:, :, 2],
        torch.zeros((n1, 5), dtype=torch.float32, device=sh.device),
    ], dim=1)
    packed[-1, 9] = 1e30  # in place on the fresh table
    return packed


def pixel_table_torch(camera: Camera, tile, pixel_offset=None):
    """The (T, P, 24) pixel table of :func:`_tile_pixel_features`: the
    plain chain. Written out one elementwise operation at a time, so that
    the pixel kernel repeats it bit for bit: the pixel centres divided by
    w and h as f32 tensors (a Python number divides a CUDA tensor as a
    product with its rounded reciprocal), |d| as a left-to-right sum, and
    the camera's rotation as its columns
    (:func:`~rtgs_tpu_torch.utils.quaternion.rotation_columns`) weighted
    one product at a time, where a library norm, sum or cross product may
    fuse or reorder."""
    w, h = camera.buf_size
    tw, th = tile
    ntx, nty = -(-w // tw), -(-h // th)
    dev = camera.device
    censor = torch.tensor((w, h), dtype=torch.float32, device=dev)
    ox, oy = (0.0, 0.0) if pixel_offset is None else pixel_offset
    i = (torch.arange(ntx * tw, dtype=torch.float32, device=dev)
         + 0.5 + ox) / censor[0]
    j = (torch.arange(nty * th, dtype=torch.float32, device=dev)
         + 0.5 + oy) / censor[1]
    uv = torch.stack(torch.meshgrid(i, j, indexing="ij"), dim=-1)
    pxy = (censor * uv - 0.5 * censor) / camera.focal_length
    px, py = pxy[..., 0], pxy[..., 1]
    norm = torch.sqrt((px * px + py * py) + 1.0)
    d = (px / norm, py / norm, -1.0 / norm)
    cols = quat.rotation_columns(camera.rotation)
    dirs = torch.stack([(d[0] * cols[0][k] + d[1] * cols[1][k])
                        + d[2] * cols[2][k] for k in range(3)],
                       dim=-1)                        # (W', H', 3)
    fd, y = direction_features(dirs)
    pix = torch.cat([dirs, fd, y], dim=-1)
    return (pix.reshape(ntx, tw, nty, th, G_DIM)
            .permute(0, 2, 1, 3, 4)
            .reshape(ntx * nty, tw * th, G_DIM))


def pixel_table_cuda(camera: Camera, tile, pixel_offset=None):
    """The (T, P, 24) pixel table from one launch of ``csrc/features.cu``'s
    pixel kernel on the current stream: bitwise :func:`pixel_table_torch`.
    The camera's tensors must be on a CUDA device (else ``ValueError``); a
    failed build or launch raises. ``pixel_table_cuda.launches`` counts the
    calls."""
    w, h = camera.buf_size
    tw, th = tile
    ntx, nty = -(-w // tw), -(-h // th)
    f32 = torch.float32
    specs = [("rotation", camera.rotation.detach().contiguous(), f32, (4,)),
             ("focal_length", camera.focal_length.detach().contiguous(), f32,
              (2,))]
    dev = check_tensors("pixel_table_cuda", specs)
    ox, oy = (0.0, 0.0) if pixel_offset is None else pixel_offset
    pix = torch.empty((ntx * nty, tw * th, G_DIM), dtype=f32, device=dev)
    _PIXELS(dev, specs[0][1].data_ptr(), specs[1][1].data_ptr(),
            pix.data_ptr(), w, h, tw, th, nty, ntx * nty * tw * th,
            float(ox), float(oy))
    pixel_table_cuda.launches += 1
    return pix


pixel_table_cuda.launches = 0


def _tile_pixel_features(camera: Camera, tile, pixel_offset=None):
    """Per-pixel features arranged (T, P, 24): dir, d-quadratic features,
    SH basis, padding past the image edge included. ``pixel_offset``:
    optional (ox, oy) subpixel jitter. On the card the pixel kernel
    (:func:`pixel_table_cuda`, which launches or raises; no input of the
    table ever requires grad), on the CPU the plain chain
    (:func:`pixel_table_torch`)."""
    if camera.device.type == "cuda":
        return pixel_table_cuda(camera, tile, pixel_offset)
    return pixel_table_torch(camera, tile, pixel_offset)


def _shade_chain(rows: torch.Tensor, pixq):
    """The quadratic chain of shading, for feature rows (..., 64) and a
    pixel-feature accessor ``pixq(j)`` that broadcasts against
    ``rows[..., j]``. Returns (a, b, cq, op, delta, valid, rho)."""
    a = sum(pixq(3 + j) * rows[..., j] for j in range(6))
    b = 2.0 * sum(pixq(j) * rows[..., 6 + j] for j in range(3))
    cq = torch.clamp(rows[..., 9], max=1e30)
    op = rows[..., 10]
    delta = b * b - 4.0 * a * cq
    sq = torch.sqrt(torch.where(delta > 0, delta, 0.0))
    t1 = (-b - sq) / (2.0 * a)
    valid = (delta > 0.0) & (t1 > 0.0)
    rho = torch.exp(torch.where(delta > 0.0, b * b / (4.0 * a) - (cq + 3.0),
                                -math.inf))
    return a, b, cq, op, delta, valid, rho


def _shade_forward(packed, sid_kp, pix):
    """The plain forward of :func:`shade_winners_kp`: torch autograd of it
    is the reference of the hand-written backward."""
    safe = torch.where(sid_kp >= 0, sid_kp, packed.shape[0] - 1).long()
    rows = packed[safe]                                # (T, K, P, F)

    def pf(j):
        return pix[:, None, :, j]                      # (T, 1, P)

    _a, _b, _cq, op, _delta, valid, rho = _shade_chain(rows, pf)
    alpha = torch.where(valid, op * rho, 0.0)
    chans = [rows[..., 11 + ch]
             + sum(pf(9 + j) * rows[..., 14 + 15 * ch + j]
                   for j in range(15))
             for ch in range(3)]
    return alpha, chans[0], chans[1], chans[2]


def winner_row_grads(rows, pixl, d_alpha, d_r, d_g, d_bl):
    """The cotangents (L, 64) of L live winners' feature rows, from their
    rows (L, 64), pixel features (L, 24) and the cotangents (L,) of their
    α, r, g, b: the quadratic chain recomputed, then each lane one chain
    factor times one pixel feature (or 1), in the lane map of
    :mod:`rtgs_tpu_torch.ops.peel`. Elementwise in L, so a winner's row
    has the same bits wherever it stands in the list; summed by splat with
    :func:`~rtgs_tpu_torch.ops.peel.segment_rows` by
    :func:`shade_winners_kp`'s backward and by the ring's owners
    (:mod:`rtgs_tpu_torch.parallel.render`)."""
    a, b, cq, op, delta, valid, rho = _shade_chain(
        rows, lambda j: pixl[:, j])
    validf = valid.to(rho.dtype)
    pos = (delta > 0.0).to(rho.dtype)
    d_op = validf * rho * d_alpha
    d_rho = validf * op * d_alpha
    d_q = pos * rho * d_rho      # rho = exp(q) where delta > 0, else 0
    d_b = (b / (2.0 * a)) * d_q
    d_a = -(b * b) / (4.0 * a * a) * d_q
    d_c0 = torch.where(cq < 1e30, -d_q, 0.0)

    d_rows = torch.empty_like(rows)
    d_rows[:, 0:6] = d_a[:, None] * pixl[:, 3:9]
    d_rows[:, 6:9] = (2.0 * d_b)[:, None] * pixl[:, 0:3]
    d_rows[:, 9] = d_c0
    d_rows[:, 10] = d_op
    y = pixl[:, 9:24]
    for ch, d_ch in enumerate((d_r, d_g, d_bl)):
        d_rows[:, 11 + ch] = d_ch
        lo = 14 + 15 * ch
        d_rows[:, lo:lo + 15] = d_ch[:, None] * y
    d_rows[:, 59:] = 0.0
    return d_rows


class _ShadeWinnersKP(torch.autograd.Function):
    """Winner shading with a hand-written backward: the counterpart of the
    JAX ``shade_winners_kp`` custom VJP (``_shade_kp_fwd``/``_shade_kp_bwd``).
    Residuals are ``packed``, the int winner ids and ``pix`` only: the
    backward gathers the rows again and recomputes the chain, so no
    (T, K, P, 64) tensor outlives the forward."""

    @staticmethod
    def forward(ctx, packed, sid_kp, pix):
        ctx.save_for_backward(packed, sid_kp, pix)
        return _shade_forward(packed, sid_kp, pix)

    @staticmethod
    def backward(ctx, d_alpha, d_r, d_g, d_bl):
        packed, sid_kp, pix = ctx.saved_tensors
        # Vacant winners shade the sentinel row, whose gradient nobody
        # reads; they are dropped before the gather, so neither their rows
        # nor their cotangents are built and the sum by splat below does
        # not pile them onto one row. nonzero lists the winners in (t, k, p)
        # order, and segment_rows adds each splat's in that order.
        ti, ki, pi = torch.nonzero(sid_kp >= 0, as_tuple=True)
        ids = sid_kp[ti, ki, pi].long()                # (L,)
        d_rows = winner_row_grads(
            packed[ids], pix[ti, pi],
            *(x[ti, ki, pi] for x in (d_alpha, d_r, d_g, d_bl)))
        return segment_rows(d_rows, ids, packed.shape[0]), None, None


def shade_winners_kp(packed: torch.Tensor, sid_kp: torch.Tensor,
                     pix: torch.Tensor):
    """α and rgb of the K winning layers per pixel.

    ``sid_kp``: (T, K, P) int32 winner ids, −1 vacant (shaded as the
    sentinel row N, which gets α = 0). ``pix``: (T, P, 24). Returns
    (alpha, r, g, b), each (T, K, P). Shading accepts Δ > 0 (the keys
    stage accepts Δ ≥ 0): a tangent ray is a hit with α = 0.

    Differentiable in ``packed`` only, through a hand-written backward
    (``sid_kp`` is index selection, and ``pix`` gets no gradient on this
    path, as in the JAX package). The backward re-gathers the winners' rows,
    recomputes the quadratic chain, and sums each splat's winners' (64-lane)
    row cotangents in (tile, layer, pixel) order with
    :func:`~rtgs_tpu_torch.ops.peel.segment_rows` (``segment_rows.cu`` on
    the card; the JAX package reduces with a mask-matmul and
    ``segment_sum``). Vacant winners are dropped before that, so row N of
    the gradient is exactly zero (the JAX scatter form adds the vacant
    layers' color cotangents there; that row is the constant sentinel and
    its gradient is discarded either way). No atomics on either pass:
    forward and gradient are bitwise repeatable.
    """
    return _ShadeWinnersKP.apply(packed, sid_kp, pix)


def composite_layers_kp(alpha, r, g, b):
    """Front-to-back composite over the K axis of (T, K, P) layers with
    exclusive-cumprod transmittance. Returns radiance (T, P, 3)."""
    trans = torch.cat([torch.ones_like(alpha[:, :1]),
                       torch.cumprod(1.0 - alpha[:, :-1], dim=1)], dim=1)
    w = trans * alpha
    return torch.stack([(w * r).sum(1), (w * g).sum(1), (w * b).sum(1)],
                       dim=-1)


def _tiles_to_image(rad: torch.Tensor, ntx: int, nty: int, tile):
    """(T, P, 3) tile-major radiance → the (W', H', 3) buffer."""
    tw, th = tile
    return (rad.reshape(ntx, nty, tw, th, 3)
            .permute(0, 2, 1, 3, 4)
            .reshape(ntx * tw, nty * th, 3))


def _band_size(t: int, tile_bands: int | None) -> int:
    """Tiles per band when ``t`` tiles run in ``tile_bands`` bands."""
    return -(-t // tile_bands) if tile_bands and tile_bands > 1 else t


def render_tiled_keys(
    g: G.Gaussians,
    camera: Camera,
    depth: int = 16,
    tile=(16, 16),
    max_candidates: int = 512,
    max_global: int = 64,
    max_tiles_local=None,
    with_stats: bool = False,
    tile_bands: int | None = None,
    pixel_offset=None,
    keys_impl: str = "auto",
    bin_narrow: int | None = None,
):
    """Full-frame render through the keys path, differentiable in the
    scene through the hand-written backward of :func:`shade_winners_kp`.
    Returns (W, H, 3) radiance on the scene's device.

    The binning and the keys kernel select only: both run under
    ``no_grad``. ``tile_bands``: run stages 3-5 over the tile axis in this
    many sequential bands, bounding the (tiles, K·P, 64) winner-row gather
    of the shading stage to one band. With gradients on, each band runs
    under activation checkpointing (the counterpart of the JAX per-band
    ``jax.checkpoint``): autograd keeps a band's inputs and its (tiles, P, 3)
    radiance, and the backward runs the band again, keys kernel included, so
    a banded forward+backward launches it 2 × bands times. Without
    gradients, and unbanded, the bands are a plain loop.
    ``with_stats=True`` also returns the binning counters: ``live``
    candidate slots, ``local_overflow`` and ``global_overflow`` (pairs
    dropped) and ``swept_pairs`` (the chunk-padded candidate total, an upper
    bound on what the keys stage sweeps). ``keys_impl`` is passed to :func:`peel_keys`.
    """
    w, h = camera.buf_size
    tw, th = tile
    ntx, nty = -(-w // tw), -(-h // th)
    dev = g.device
    with span("render.features", dev):
        packed = pack_features(precompute_features(g, camera))
    with torch.no_grad():
        with span("render.entry_lb", dev):
            entry_lb = entry_lower_bound(g, camera, packed)
        with span("render.binning", dev):
            binning = tile_candidates(
                g, camera, tile=tile, max_candidates=max_candidates,
                max_global=max_global, max_tiles_local=max_tiles_local,
                pad_px=0.0 if pixel_offset is None else 0.5,
                narrow=bin_narrow, chunk=CHUNK, entry_lb=entry_lb)
    cand, lb = binning.candidates, binning.chunk_lb
    with span("render.features", dev):
        pix = _tile_pixel_features(camera, tile, pixel_offset)

    def band(packed, cand_b, pix_b, lb_b, counts_b):
        with torch.no_grad():
            _t1, sid = peel_keys(packed, cand_b, pix_b, depth,
                                 impl=keys_impl, chunk_lb=lb_b,
                                 counts=counts_b)
        return composite_layers_kp(*shade_winners_kp(packed, sid, pix_b))

    t = cand.shape[0]
    nb = _band_size(t, tile_bands)
    remat = nb < t and torch.is_grad_enabled() and packed.requires_grad
    rads = []
    with span("render.keys_shade", dev):
        for s in range(0, t, nb):
            args = (packed, cand[s:s + nb], pix[s:s + nb], lb[s:s + nb],
                    binning.counts[s:s + nb])
            if remat:
                rads.append(torch.utils.checkpoint.checkpoint(
                    band, *args, use_reentrant=False,
                    preserve_rng_state=False))
            else:
                rads.append(band(*args))
    with span("render.assemble", dev):
        rad = torch.cat(rads)
        img = _tiles_to_image(rad, ntx, nty, tile)[:w, :h]
        if not with_stats:
            return img
        stats = {
            "live": (binning.candidates >= 0).sum(),
            "local_overflow": binning.local_overflow,
            "global_overflow": binning.global_overflow,
            "swept_pairs": ((binning.counts + CHUNK - 1) // CHUNK
                            * CHUNK).sum(),
        }
        return img, stats


def render_tiled_pallas(
    g: G.Gaussians,
    camera: Camera,
    depth: int = 16,
    tile=(16, 16),
    max_candidates: int = 512,
    max_global: int = 64,
    max_tiles_local=None,
    with_stats: bool = False,
    tile_bands: int | None = None,
    pixel_offset=None,
    bin_narrow: int | None = None,
    peel_impl: str = "auto",
):
    """Full-frame render through the fused-payload peel (port of the JAX
    ``render_tiled_pallas``, under its name): differentiable in the scene
    through the peel's hand-written backward. Returns (W, H, 3) radiance.

    The binning yields indices only, so it runs under ``no_grad``; the
    candidates are padded with −1 to a multiple of ``CHUNK``.
    ``tile_bands``: run the peel over the tile axis in this many sequential
    bands (a plain loop; each band's autograd node keeps only its inputs and
    the winners' slots). ``with_stats=True`` also returns the binning
    counters ``live``, ``local_overflow`` and ``global_overflow``.
    ``peel_impl`` is passed to :func:`~rtgs_tpu_torch.ops.peel.peel_fused`.
    """
    w, h = camera.buf_size
    tw, th = tile
    ntx, nty = -(-w // tw), -(-h // th)
    dev = g.device
    with torch.no_grad(), span("render.binning", dev):
        binning = tile_candidates(
            g, camera, tile=tile, max_candidates=max_candidates,
            max_global=max_global, max_tiles_local=max_tiles_local,
            pad_px=0.0 if pixel_offset is None else 0.5, narrow=bin_narrow)
        cand = binning.candidates
        pad_c = (-cand.shape[1]) % CHUNK
        if pad_c:
            cand = F.pad(cand, (0, pad_c), value=-1)
    with span("render.features", dev):
        packed = pack_features(precompute_features(g, camera))
        pix = _tile_pixel_features(camera, tile, pixel_offset)

    t = cand.shape[0]
    nb = _band_size(t, tile_bands)
    with span("render.peel", dev):
        rads = [peel_fused(packed, cand[s:s + nb], pix[s:s + nb], depth,
                           impl=peel_impl)[0]
                for s in range(0, t, nb)]               # (T, 3, P) each
    with span("render.assemble", dev):
        rad = torch.cat(rads)
        img = _tiles_to_image(rad.transpose(1, 2), ntx, nty, tile)[:w, :h]
        if not with_stats:
            return img
        stats = {
            "live": (binning.candidates >= 0).sum(),
            "local_overflow": binning.local_overflow,
            "global_overflow": binning.global_overflow,
        }
        return img, stats


def intersect_candidates(feats: TileFeatures, cand: torch.Tensor,
                         dirs: torch.Tensor):
    """Intersect each tile's pixels with its candidate list, for a batch
    of B tiles (the JAX function is one tile, under ``vmap``).

    Args:
      feats: camera-folded features.
      cand: (B, C) int32 candidate ids, −1 padded.
      dirs: (B, P, 3) unit pixel ray directions.

    Returns:
      (t1, alpha, rgb): (B, P, C), (B, P, C), (B, P, C, 3). t1 is the
      float64 entry depth of :func:`~rtgs_tpu_torch.ops.peel.entry_depth`
      rounded once, without gradient (the order it sets is piecewise
      constant); invalid entries have ``t1 = +inf`` and ``alpha = 0``.
      α and rgb are f32, differentiable in ``feats``. A and B are summed
      lane by lane in the order of the other tile renderers' shading
      (:func:`~rtgs_tpu_torch.ops.peel._shade_layers`): the exponent
      B²/4A − (c0+3) cancels, so another order (the JAX package's
      matmul) moves α by up to ~1e-2 relative at small splats.
    """
    safe = torch.where(cand >= 0, cand, feats.c0.shape[0] - 1).long()
    m6, me = feats.m6[safe], feats.me[safe]       # (B, C, 6), (B, C, 3)
    # The sentinel's inf c0 would make NaN (0·inf) downstream.
    c0 = feats.c0[safe]
    c0 = torch.where(torch.isfinite(c0), c0, 1e30)
    op, col, sh = feats.opacity[safe], feats.color[safe], feats.sh[safe]

    fd, y = direction_features(dirs)              # (B, P, 6), (B, P, 15)
    with torch.no_grad():
        t1 = entry_depth(torch.cat([m6, me, c0[..., None]], dim=-1),
                         torch.cat([dirs, fd], dim=-1))
    a = fd[..., 0:1] * m6[:, None, :, 0]          # (B, P, C)
    for j in range(1, 6):
        a = a + fd[..., j:j + 1] * m6[:, None, :, j]
    b = dirs[..., 0:1] * me[:, None, :, 0]
    for j in range(1, 3):
        b = b + dirs[..., j:j + 1] * me[:, None, :, j]
    b = 2.0 * b
    cq = c0[:, None, :]
    delta = b * b - (4.0 * a) * cq
    # ρ at the chord midpoint: exp(B²/4A − (c0+3)); Δ ≤ 0 → ρ = 0. The
    # exponent is −inf there, not exp's overflow, so no inf meets a zero
    # cotangent.
    rho = torch.exp(torch.where(delta > 0.0, b * b / (4.0 * a) - (cq + 3.0),
                                -math.inf))
    valid = torch.isfinite(t1)
    alpha = torch.where(valid, op[:, None, :] * rho, 0.0)
    # rgb[b, p, c, ch] = color[c, ch] + Σₖ y[p, k] sh[c, k, ch].
    rgb = col[:, None, :, :] + torch.einsum("bpk,bckh->bpch", y, sh)
    return t1, alpha, rgb


def peel_block(t1, alpha, rgb, depth: int):
    """K masked-argmin peel steps over (B, P, C) blocks: the reference's
    per-launch peel as a fixed-trip-count loop. Each step takes the first
    candidate (lowest slot) of the smallest remaining t1, so ties go to
    the lower slot. The argmin runs without gradient; the chosen entries'
    α and rgb are gathered, so the gradient reaches only them.

    Returns (radiance (B, P, 3), transmittance (B, P))."""
    c = t1.shape[-1]
    with torch.no_grad():
        lane = torch.arange(c, device=t1.device)
        t1m = t1.clone()
        picks, found = [], []
        for _ in range(depth):
            m = t1m.amin(dim=-1, keepdim=True)
            hit = torch.isfinite(m)
            first = torch.where((t1m == m) & hit, lane, c).amin(
                dim=-1, keepdim=True)                 # (B, P, 1)
            idx = first.clamp(max=c - 1)              # c: no hit left
            t1m.scatter_(-1, idx, math.inf)
            picks.append(idx)
            found.append(hit)
    rad = torch.zeros(t1.shape[:-1] + (3,), dtype=alpha.dtype,
                      device=alpha.device)
    trans = torch.ones(t1.shape[:-1], dtype=alpha.dtype, device=alpha.device)
    for idx, hit in zip(picks, found):
        a = torch.where(hit, alpha.gather(-1, idx), 0.0)[..., 0]
        col = rgb.gather(2, idx[..., None].expand(*idx.shape, 3))[..., 0, :]
        rad = rad + (trans * a)[..., None] * col
        trans = trans * (1.0 - a)
    return rad, trans


def _peel_tiles(feats: TileFeatures, depth: int, cand, dirs):
    """:func:`intersect_candidates` then :func:`peel_block` for a batch of
    tiles (the JAX ``_peel_one_tile`` under ``vmap``)."""
    return peel_block(*intersect_candidates(feats, cand, dirs), depth)


def render_tiled(
    g: G.Gaussians,
    camera: Camera,
    depth: int = 16,
    tile=(16, 16),
    max_candidates: int = 512,
    max_global: int = 64,
    tile_chunk: int | None = None,
    max_tiles_local=None,
    pixel_offset=None,
    bin_narrow: int | None = None,
):
    """Full-frame render through the per-tile argmin peel (port of the
    JAX ``render_tiled``). Returns (W, H, 3) radiance, differentiable in
    the scene through torch autograd.

    The tiles run in chunks of ``tile_chunk`` (default: the (chunk, P, C)
    intermediates bounded to 2²⁴ elements), one after the other. With
    gradients on, each chunk runs under activation checkpointing, so
    autograd keeps only the chunk's inputs and outputs and re-runs the
    chunk in the backward pass.
    """
    w, h = camera.buf_size
    tw, th = tile
    ntx, nty = -(-w // tw), -(-h // th)
    with torch.no_grad():
        binning = tile_candidates(
            g, camera, tile=tile, max_candidates=max_candidates,
            max_global=max_global, max_tiles_local=max_tiles_local,
            pad_px=0.0 if pixel_offset is None else 0.5, narrow=bin_narrow)
    cand = binning.candidates
    feats = precompute_features(g, camera)
    dirs = _tile_pixel_features(camera, tile, pixel_offset)[..., :3]

    t, c2 = cand.shape
    if tile_chunk is None:
        tile_chunk = max(1, min(t, (1 << 24) // (tw * th * max(c2, 1))))
    grad = torch.is_grad_enabled() and any(
        getattr(feats, f).requires_grad for f in FEATURE_FIELDS)
    rads = []
    for s in range(0, t, tile_chunk):
        args = (feats, depth, cand[s:s + tile_chunk], dirs[s:s + tile_chunk])
        if grad:
            rad, _ = torch.utils.checkpoint.checkpoint(
                _peel_tiles, *args, use_reentrant=False)
        else:
            rad, _ = _peel_tiles(*args)
        rads.append(rad)
    return _tiles_to_image(torch.cat(rads), ntx, nty, tile)[:w, :h]
