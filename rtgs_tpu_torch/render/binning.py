"""Screen-tile candidate binning (port of :mod:`rtgs_tpu.render.binning`).

Per frame: project every Gaussian's 3σ AABB into the image, enumerate the
tiles it covers, sort the (tile, depth) keyed pairs once, and cut a
fixed-width ``(tiles, C)`` candidate matrix out of the sorted stream. A ray
hits the ``xᵀΣ⁻¹x = 3`` ellipsoid only inside the Gaussian's AABB, so the
lists never miss a hit. Gaussians touching the camera plane, or spanning
more tiles than the local fan-out allows, go to a per-frame global list that
rides first in every tile's row.

Within a tile, candidates are ordered by a quantized lower bound on their
entry depth (center depth − √3·s_max), so an overflowing tile drops its
farthest Gaussians first, and ``chunk_lb`` lets the keys kernel stop its
chunk sweep exactly.

The JAX version's compile-time workarounds have direct torch forms: its
blocked ``_tree_cumsum`` is ``torch.cumsum``, and its vmapped
``dynamic_slice`` rows are one index gather. The gather-form gradient plan
(``GradPlan``) is not ported: it is off by default there and measured a net
loss.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.camera import Camera
from rtgs_tpu_torch.utils import quaternion as quat

_INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class TileBinning:
    """Result of :func:`tile_candidates`.

    Attributes:
      candidates: (T, C) int32 Gaussian ids per tile, ``-1`` padded; the
        valid ids of a tile form a prefix: the global list first, then the
        tile's own Gaussians nearest first.
      n_tiles_x / n_tiles_y: tile grid (tile index ``T = tx · nty + ty``).
      local_overflow: () candidate slots dropped because a tile exceeded
        ``max_candidates`` (farthest first).
      global_overflow: () Gaussians beyond the global list's ``max_global``.
      counts: (T,) int32 valid-prefix length per tile.
      chunk_lb: (T, C/chunk + 1) f32, only when ``chunk`` is given: per
        candidate chunk, a lower bound on the entry depth t1 of every
        candidate in that chunk or a later one (suffix min; +inf where the
        suffix is empty, 0.0 in the trailing guard column and wherever no
        bound is available).
    """

    candidates: torch.Tensor
    n_tiles_x: int
    n_tiles_y: int
    local_overflow: torch.Tensor
    global_overflow: torch.Tensor
    counts: torch.Tensor
    chunk_lb: torch.Tensor | None = None


def _camera_space(points: torch.Tensor, camera: Camera) -> torch.Tensor:
    """World → camera coordinates ``Rᵀ (p − pos)`` (camera looks −z)."""
    r = quat.as_rotation_mat3(camera.rotation)
    return (points - camera.position) @ r


def tile_candidates(
    g: G.Gaussians,
    camera: Camera,
    tile=(16, 16),
    max_candidates: int = 512,
    max_tiles_local=None,
    max_global: int = 128,
    pad_px: float = 0.0,
    narrow: int | None = None,
    chunk: int | None = None,
) -> TileBinning:
    """Build fixed-width per-tile candidate lists on the scene's device.

    ``max_tiles_local`` defaults to ~128 px of screen coverage per axis;
    wider splats go to the global list. ``narrow`` (default 4) is the
    narrow-class fan-out width in tiles: splats covering at most
    ``narrow × narrow`` tiles fan out to that many slots, the rarer wide
    ones are compacted to a budget of ``max(64, N/16)`` and fan out to the
    full ``max_tiles_local`` rectangle, and wide splats beyond the budget
    spill to the global list. ``chunk``: pad the candidate width to a
    multiple of it and return ``chunk_lb``. ``pad_px`` widens every
    projected box (subpixel jitter).
    """
    w, h = camera.buf_size
    tw, th = tile
    ntx, nty = -(-w // tw), -(-h // th)
    num_tiles = ntx * nty
    if max_tiles_local is None:
        max_tiles_local = (min(max(2, -(-128 // tw)), ntx),
                           min(max(2, -(-128 // th)), nty))
    mtx, mty = max_tiles_local
    n = g.num
    dev = g.device
    i32 = torch.int32

    # --- Project the AABB corners. ---
    pmin, pmax = G.aabb(g.means, g.quats, g.scales)
    lohi = torch.stack([pmin, pmax], dim=1)  # (N, 2, 3)
    sel = torch.tensor([[x, y, z] for x in (0, 1) for y in (0, 1)
                        for z in (0, 1)], device=dev)  # (8, 3)
    corners = torch.stack([lohi[:, sel[:, 0], 0], lohi[:, sel[:, 1], 1],
                           lohi[:, sel[:, 2], 2]], dim=-1)  # (N, 8, 3)
    pc = _camera_space(corners.reshape(-1, 3), camera).reshape(n, 8, 3)
    z = pc[..., 2]
    eps = 1e-6
    behind = torch.any(z > -eps, dim=-1)
    zsafe = torch.clamp(z, max=-eps)
    fx, fy = camera.focal_length[0], camera.focal_length[1]
    # Pixel-center coordinates: pixel i's ray is at px == i.
    px = fx * pc[..., 0] / (-zsafe) + (w / 2 - 0.5)
    py = fy * pc[..., 1] / (-zsafe) + (h / 2 - 0.5)
    px_min, px_max = px.amin(-1) - pad_px, px.amax(-1) + pad_px
    py_min, py_max = py.amin(-1) - pad_px, py.amax(-1) + pad_px

    off_screen = ((px_max < -0.5) | (px_min > w - 0.5)
                  | (py_max < -0.5) | (py_min > h - 0.5))
    live = (g.mask > 0) & (behind | ~off_screen)

    def tile_of(v, nt, t):
        return torch.clamp(torch.floor(v / t), 0, nt - 1).to(i32)

    tx0, tx1 = tile_of(px_min, ntx, tw), tile_of(px_max, ntx, tw)
    ty0, ty1 = tile_of(py_min, nty, th), tile_of(py_max, nty, th)
    wx, wy = tx1 - tx0 + 1, ty1 - ty0 + 1

    is_global = live & (behind | (wx > mtx) | (wy > mty))
    is_local = live & ~is_global

    # --- Quantized entry-depth lower bound: the in-tile sort key, the drop
    # order and the kernel's early-exit bound. Truncation rounds down, so
    # the dequantized bound stays ≤ t1. The clamp to 65534 keeps the
    # farthest global pair's key below the dead-slot sentinel INT32_MAX at
    # num_tiles == 32767. ---
    depth = -_camera_space(g.means, camera)[:, 2]
    lb = torch.clamp(depth - math.sqrt(G.BOUNDING_THRESHOLD)
                     * g.scales.amax(-1), min=0.0)
    dmax = torch.clamp(torch.where(live, lb, 0.0).amax(), min=1e-6)
    dq = torch.clamp(lb / dmax * 65535.0, 0, 65534).to(i32)

    # With more tiles than a packed int32 key can hold, keys carry the tile
    # only: drop order within a tile becomes arbitrary and chunk_lb is 0.
    packed_key = num_tiles <= (1 << 15) - 1
    shift = 65536 if packed_key else 1

    narrow = min(4 if narrow is None else narrow, mtx, mty)
    is_wide = is_local & ((wx > narrow) | (wy > narrow))
    is_narrow = is_local & ~is_wide

    def fan_out(sel, tx0s, ty0s, wxs, wys, dqs, span_x, span_y):
        dx = torch.arange(span_x, dtype=i32, device=dev)
        dy = torch.arange(span_y, dtype=i32, device=dev)
        tid = ((tx0s[None, :] + dx[:, None])[:, None, :] * nty
               + (ty0s[None, :] + dy[:, None])[None, :, :])  # (sx, sy, L)
        ok = (sel[None, None, :]
              & (dx[:, None, None] < wxs[None, None, :])
              & (dy[None, :, None] < wys[None, None, :]))
        key = tid * shift + dqs[None, None, :] if packed_key else tid
        return torch.where(ok, key, _INT32_MAX).reshape(span_x * span_y, -1)

    ids = torch.arange(n, dtype=i32, device=dev)
    key_n = fan_out(is_narrow, tx0, ty0, wx, wy, dq, narrow, narrow)
    keys, vals = [key_n.reshape(-1)], [ids.expand_as(key_n).reshape(-1)]
    if mtx > narrow or mty > narrow:
        # Compact the wide splats (in id order) to a budget, then fan each
        # out over the full rectangle; slot ``wlimit`` takes the rest and is
        # cut off.
        wlimit = max(64, n // 16)
        wpos = torch.cumsum(is_wide.to(i32), 0, dtype=i32) - 1
        wdst = torch.where(is_wide & (wpos < wlimit), wpos, wlimit)
        widx = torch.full((wlimit + 1,), n, dtype=i32, device=dev)
        widx = widx.scatter(0, wdst.long(), ids)[:wlimit]
        wlive = widx < n
        wsafe = torch.clamp(widx, max=n - 1).long()
        key_w = fan_out(wlive, tx0[wsafe], ty0[wsafe], wx[wsafe],
                        wy[wsafe], dq[wsafe], mtx, mty)
        keys.append(key_w.reshape(-1))
        vals.append(wsafe.to(i32).expand(key_w.shape).reshape(-1))
        # Budget spill goes to the global list (conservative, never lost).
        is_global = is_global | (is_wide & (wpos >= wlimit))

    # --- Global pairs ride the same sort under the sentinel tile id
    # num_tiles, so the global list comes out nearest first. ---
    key_g = num_tiles * shift + dq if packed_key else torch.full_like(
        dq, num_tiles)
    keys.append(torch.where(is_global, key_g, _INT32_MAX))
    vals.append(ids)
    key_s, order = torch.sort(torch.cat(keys), stable=True)
    val_s = torch.cat(vals)[order]

    # Tile t's pairs span [offs[t], offs[t+1]); the global list is segment
    # num_tiles; dead pairs (INT32_MAX) sort past the last boundary.
    bounds = torch.cat([
        torch.arange(num_tiles + 1, dtype=i32, device=dev) * shift,
        torch.tensor([_INT32_MAX], dtype=i32, device=dev)])
    offs = torch.searchsorted(key_s, bounds, side="left", out_int32=True)
    tcounts = offs[1:] - offs[:-1]                        # (T+1,)

    cl = torch.clamp(tcounts[:num_tiles], max=max_candidates)   # (T,)
    n_glob = torch.clamp(tcounts[num_tiles], max=max_global)
    total_c = max_candidates + max_global
    if chunk:
        total_c += (-total_c) % chunk

    # Row t = [global list | tile t's pairs], one gather from the stream.
    j = torch.arange(total_c, dtype=i32, device=dev)[None, :]
    lj = j - n_glob
    ok = (j < n_glob) | ((lj >= 0) & (lj < cl[:, None]))
    src = torch.where(j < n_glob, offs[num_tiles] + j,
                      offs[:num_tiles, None] + lj)
    src = torch.clamp(src, 0, key_s.shape[0] - 1).long()
    candidates = torch.where(ok, val_s[src], -1)
    local_overflow = torch.clamp(tcounts[:num_tiles] - max_candidates,
                                 min=0).sum()
    global_overflow = torch.clamp(tcounts[num_tiles] - max_global, min=0)
    counts = cl + n_glob

    chunk_lb = None
    if chunk:
        nchunk = total_c // chunk
        if packed_key:
            lb_slot = torch.where(
                ok, (key_s[src] & 0xFFFF).float() * (dmax / 65535.0),
                math.inf)
            cmin = lb_slot.reshape(num_tiles, nchunk, chunk).amin(2)
            chunk_lb = torch.cummin(cmin.flip(1), dim=1).values.flip(1)
        else:
            chunk_lb = torch.zeros((num_tiles, nchunk), device=dev)
        chunk_lb = torch.cat(
            [chunk_lb, torch.zeros((num_tiles, 1), device=dev)], dim=1)
    return TileBinning(candidates, ntx, nty, local_overflow, global_overflow,
                       counts, chunk_lb)
