"""The plain reference of a frame, in PyTorch alone and in any dtype.

A pixel's ray o + t·d (d unit, through the pixel's center) meets splat i
where (x − μᵢ)ᵀΣᵢ⁻¹(x − μᵢ) = 3, Σᵢ = Rᵢ Sᵢ² Rᵢᵀ. The frame keeps, for
every pixel, the ``depth`` hits of smallest entry depth t1 > 0 and
composites them front to back: radiance Σₖ Tₖ αₖ cₖ with Tₖ = Πⱼ<ₖ (1 − αⱼ),
no background. A hit's response is the Gaussian at the point of the ray
nearest to μᵢ in Σᵢ⁻¹'s metric, ρ = exp(−q) with q = min_t (x − μ)ᵀΣ⁻¹(x − μ)
(no ½), and α = opacity·ρ, 0 for a tangent ray (q = 3). Its color is the
base color plus the real SH of degrees 1-3 at the pixel's direction. This
is the contract of the port's renderers (``rtgs_tpu_torch/render``) and of
the JAX package's, written again from the scene's fields.

The arithmetic avoids cancellation: each pair is taken relative to the point
p_c of the ray nearest (Euclidean) to μ, w = p_c − μ, and in the splat's
frame w̃ = S⁻¹Rᵀw, d̃ = S⁻¹Rᵀd, so q = |w̃ + s*d̃|² with s* = −w̃·d̃/|d̃|² and
t1 = t_c + s* − √(3 − q)/|d̃|. In float64 that is exact to ~1e-12; the port
forms q as B²/4A − c0 from a float32 table, which cancels.

The binning is this file's own and drops nothing: a splat's ellipsoid lies
in its axis-aligned box, half-widths √(3Σᵢᵢ), and a ray that meets it in
front of the camera passes through the box, whose projection lies in the
bounds of its projected corners (a pixel's margin is added). A box that
reaches the camera's plane goes to every tile.
"""

from __future__ import annotations

import math

import torch

TILE = 16
# Pairs (pixel, candidate) evaluated at once: bounds the temporaries of a
# chunk of tiles (a (pairs, 3) float64 tensor is 384 MiB at 2**24).
PAIR_BUDGET = 2**24
# Pixels shaded at once outside autograd.
SHADE_PIXELS = 2**17


def rotation(quats: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) rotations of unit scalar-last quaternions (N, 4)."""
    x, y, z, w = quats.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def sh_basis(d: torch.Tensor) -> torch.Tensor:
    """The real SH basis of degrees 1-3 at unit directions (..., 3), in the
    renderers' order and scaling: (..., 15). Slot 11 is 5z² − 3z where the
    textbook Y₃₀ has 5z³ − 3z: the upstream renderer's form, which both
    packages keep."""
    x, y, z = d.unbind(-1)
    c0, c1, c2 = math.sqrt(3 / math.pi), math.sqrt(15 / math.pi), \
        math.sqrt(5 / math.pi)
    c3, c4 = math.sqrt(35 / (2 * math.pi)), math.sqrt(105 / math.pi)
    c5, c6 = math.sqrt(21 / (2 * math.pi)), math.sqrt(7 / math.pi)
    return torch.stack([
        0.5 * c0 * y, 0.5 * c0 * z, 0.5 * c0 * x,
        0.5 * c1 * x * y, 0.5 * c1 * y * z, 0.25 * c2 * (3 * z * z - 1),
        0.5 * c1 * x * z, 0.25 * c1 * (x * x - y * y),
        0.25 * c3 * y * (3 * x * x - y * y), 0.5 * c4 * x * y * z,
        0.25 * c5 * y * (5 * z * z - 1), 0.25 * c6 * (5 * z * z - 3 * z),
        0.25 * c5 * x * (5 * z * z - 1), 0.25 * c4 * (x * x - y * y) * z,
        0.25 * c3 * x * (x * x - 3 * y * y),
    ], -1)


class Camera:
    """A pinhole camera: ``origin`` (3,), ``axes`` (3, 3) whose columns are
    right, up and back (it looks down −back), the vertical FOV in degrees
    and the image size (W, H). Pixel (i, j), j counted from the bottom row,
    looks along right·(i + ½ − W/2)/f + up·(j + ½ − H/2)/f − back,
    f = (H/2)/tan(fov/2)."""

    def __init__(self, origin, axes, res, fov_deg):
        self.origin, self.axes = origin, axes
        self.w, self.h = int(res[0]), int(res[1])
        self.focal = (self.h / 2.0) / math.tan(math.radians(fov_deg) / 2.0)

    def dirs(self, dtype, device) -> torch.Tensor:
        """Unit ray directions (W, H, 3)."""
        i = (torch.arange(self.w, dtype=torch.float64) + 0.5
             - self.w / 2.0) / self.focal
        j = (torch.arange(self.h, dtype=torch.float64) + 0.5
             - self.h / 2.0) / self.focal
        a = self.axes.to(torch.float64)
        d = (i[:, None, None] * a[:, 0] + j[None, :, None] * a[:, 1]
             - a[:, 2])
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        return d.to(device=device, dtype=dtype)


def frame_fields(scene: dict, dtype) -> dict:
    """The fields a frame reads, in ``dtype``: means, the rotations, the
    inverse scales, opacities, colors and SH."""
    q = scene["quats"].to(dtype)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return dict(means=scene["means"].to(dtype), rot=rotation(q),
                inv_scales=1.0 / scene["scales"].to(dtype),
                opacities=scene["opacities"].to(dtype),
                colors=scene["colors"].to(dtype), sh=scene["sh"].to(dtype))


def _pair_terms(f: dict, ids: torch.Tensor, o: torch.Tensor,
                d: torch.Tensor):
    """For splats ``ids`` (..., C) against directions ``d`` (..., 3)
    broadcast to them: (q, entry depth t1), each (..., C); t1 is +inf
    where the ray misses the ellipsoid or meets it behind the camera."""
    mu = f["means"][ids]                                 # (..., C, 3)
    a = f["rot"][ids] * f["inv_scales"][ids][..., None, :]   # R S⁻¹
    dd = d[..., None, :]                                 # (..., 1, 3)
    t_c = ((mu - o) * dd).sum(-1)                        # (..., C)
    w = o + t_c[..., None] * dd - mu
    # S⁻¹Rᵀw and S⁻¹Rᵀd, a component at a time (no (..., C, 3, 3) product).
    w_t = [sum(a[..., i, k] * w[..., i] for i in range(3)) for k in range(3)]
    d_t = [sum(a[..., i, k] * dd[..., i] for i in range(3))
           for k in range(3)]
    dd_t = sum(x * x for x in d_t)
    s_star = -sum(x * y for x, y in zip(w_t, d_t)) / dd_t
    q = sum((x + s_star * y) ** 2 for x, y in zip(w_t, d_t))
    t1 = t_c + s_star - torch.sqrt(torch.clamp(3.0 - q, min=0.0)) / \
        torch.sqrt(dd_t)
    return q, torch.where((q <= 3.0) & (t1 > 0), t1, math.inf)


def shade(f: dict, o: torch.Tensor, d: torch.Tensor,
          winners: torch.Tensor) -> torch.Tensor:
    """Radiance (..., 3) of the winners (..., K), nearest first, −1 where a
    pixel has fewer hits, along directions ``d`` (..., 3): differentiable
    in the fields of ``f``."""
    ok = winners >= 0
    ids = torch.where(ok, winners, 0)
    q, _ = _pair_terms(f, ids, o, d)
    alpha = torch.where(ok & (q < 3.0),
                        f["opacities"][ids] * torch.exp(-q), 0.0)
    y = sh_basis(d)                                      # (..., 15)
    rgb = f["colors"][ids] + (y[..., None, :, None] * f["sh"][ids]).sum(-2)
    trans = torch.cumprod(1.0 - alpha, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    return ((trans * alpha)[..., None] * rgb).sum(-2)


def tile_lists(f: dict, cam: Camera, device):
    """The conservative binning: (tile order (T,) by candidate count,
    offsets (T + 1,) into ``splats``, splats (pairs,)), tiles numbered
    ty·ntx + tx over 16×16 pixel tiles."""
    dtype = torch.float64
    mu = f["means"].to(dtype)
    rot = f["rot"].to(dtype)
    s2 = (1.0 / f["inv_scales"].to(dtype)) ** 2
    half = torch.sqrt(3.0 * (rot * rot * s2[:, None, :]).sum(-1))  # (N, 3)
    signs = torch.tensor([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                          for sz in (-1, 1)], dtype=dtype, device=device)
    corners = mu[:, None, :] + signs[None] * half[:, None, :]     # (N, 8, 3)
    axes = cam.axes.to(device=device, dtype=dtype)
    pc = (corners - cam.origin.to(device=device, dtype=dtype)) @ axes
    depth = -pc[..., 2]
    front = (depth > 1e-9).all(-1)
    safe = torch.where(depth > 1e-9, depth, 1.0)
    u = cam.w / 2.0 + cam.focal * pc[..., 0] / safe     # pixel i's ray at i + ½
    v = cam.h / 2.0 + cam.focal * pc[..., 1] / safe
    ntx, nty = -(-cam.w // TILE), -(-cam.h // TILE)
    # Pixels whose centers lie in [lo, hi], widened by one pixel.
    i0 = torch.floor(u.amin(-1) - 0.5) - 1
    i1 = torch.ceil(u.amax(-1) - 0.5) + 1
    j0 = torch.floor(v.amin(-1) - 0.5) - 1
    j1 = torch.ceil(v.amax(-1) - 0.5) + 1
    seen = ~front | ((i1 >= 0) & (i0 <= cam.w - 1) & (j1 >= 0)
                     & (j0 <= cam.h - 1))
    tx0 = torch.where(front, torch.clamp(i0, 0, cam.w - 1) // TILE, 0).long()
    tx1 = torch.where(front, torch.clamp(i1, 0, cam.w - 1) // TILE,
                      ntx - 1).long()
    ty0 = torch.where(front, torch.clamp(j0, 0, cam.h - 1) // TILE, 0).long()
    ty1 = torch.where(front, torch.clamp(j1, 0, cam.h - 1) // TILE,
                      nty - 1).long()
    sid = torch.nonzero(seen).squeeze(1)
    nx, ny = (tx1 - tx0 + 1)[sid], (ty1 - ty0 + 1)[sid]
    cnt = nx * ny
    pair_sid = torch.repeat_interleave(sid, cnt)
    start = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    local = torch.arange(pair_sid.shape[0], device=device) - start
    nyp = torch.repeat_interleave(ny, cnt)
    tx = tx0[pair_sid] + local // nyp
    ty = ty0[pair_sid] + local % nyp
    tile = ty * ntx + tx
    order = torch.argsort(tile, stable=True)
    splats = pair_sid[order]
    counts = torch.bincount(tile, minlength=ntx * nty)
    offsets = torch.zeros(ntx * nty + 1, dtype=torch.long, device=device)
    offsets[1:] = torch.cumsum(counts, 0)
    return torch.argsort(counts, stable=True), offsets, splats


def select(f: dict, cam: Camera, depth: int, device) -> torch.Tensor:
    """The ``depth`` nearest hits of every pixel: splat ids (W, H, K), −1
    past a pixel's last hit, nearest first; in ``f``'s dtype."""
    dtype = f["means"].dtype
    ntx = -(-cam.w // TILE)
    tiles_by_count, offsets, splats = tile_lists(f, cam, device)
    counts = offsets[1:] - offsets[:-1]
    dirs = cam.dirs(dtype, device)
    o = cam.origin.to(device=device, dtype=dtype)
    out = torch.full((cam.w, cam.h, depth), -1, dtype=torch.long,
                     device=device)
    counts_h = counts[tiles_by_count].tolist()
    order_h = tiles_by_count.tolist()
    offsets_h = offsets.tolist()
    lo = 0
    while lo < len(order_h):
        # Tiles in ascending count: a chunk pads to its last tile's count.
        hi = lo + 1
        while (hi < len(order_h)
               and (hi + 1 - lo) * max(counts_h[hi], 1) * TILE * TILE
               <= PAIR_BUDGET):
            hi += 1
        tiles = order_h[lo:hi]
        rows = [splats[offsets_h[t]:offsets_h[t + 1]] for t in tiles]
        idx = torch.tensor(tiles, device=device)
        cand = torch.nn.utils.rnn.pad_sequence(
            rows, batch_first=True, padding_value=-1)
        if cand.shape[1] == 0:
            lo = hi
            continue
        tx, ty = idx % ntx, idx // ntx
        px = tx[:, None] * TILE + torch.arange(TILE, device=device)
        py = ty[:, None] * TILE + torch.arange(TILE, device=device)
        px = px[:, :, None].expand(-1, TILE, TILE).clamp(max=cam.w - 1)
        py = py[:, None, :].expand(-1, TILE, TILE).clamp(max=cam.h - 1)
        d = dirs[px, py].reshape(len(tiles), TILE * TILE, 3)
        ok = cand >= 0
        ids = torch.where(ok, cand, 0)[:, None, :]
        _, t1 = _pair_terms(f, ids, o, d)
        t1 = torch.where(ok[:, None, :], t1, math.inf)
        k = min(depth, t1.shape[-1])
        best, at = torch.topk(t1, k, dim=-1, largest=False, sorted=True)
        won = torch.gather(ids.expand(-1, TILE * TILE, -1), -1, at)
        won = torch.where(torch.isfinite(best), won, -1)
        pxf = px.reshape(len(tiles), -1)
        pyf = py.reshape(len(tiles), -1)
        out[pxf, pyf, :k] = won
        lo = hi
    return out


@torch.no_grad()
def frame(scene: dict, cam: Camera, depth: int, dtype=torch.float64):
    """The reference frame (W, H, 3) of ``scene`` (the benchmark's fields,
    on the device it runs on) from ``cam``, computed in ``dtype``
    throughout and returned in float64, and each pixel's number of layers
    composited, min(hits, ``depth``) (W, H)."""
    device = scene["means"].device
    f = frame_fields(scene, dtype)
    winners = select(f, cam, depth, device)
    dirs = cam.dirs(dtype, device).reshape(-1, 3)
    o = cam.origin.to(device=device, dtype=dtype)
    flat = winners.reshape(-1, depth)
    img = torch.cat([shade(f, o, dirs[s:s + SHADE_PIXELS],
                           flat[s:s + SHADE_PIXELS])
                     for s in range(0, flat.shape[0], SHADE_PIXELS)])
    return (img.reshape(cam.w, cam.h, 3).to(torch.float64),
            (winners >= 0).sum(-1))


def render(scene: dict, cam: Camera, depth: int,
           dtype=torch.float64) -> torch.Tensor:
    """The reference frame alone (:func:`frame`)."""
    return frame(scene, cam, depth, dtype)[0]
