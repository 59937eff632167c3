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

Two implementations with one contract: the hand-written kernels
(``ops/csrc/binning.cu``: :func:`tile_candidates_cuda`) and the plain torch
chain (:func:`tile_candidates_torch`); :func:`tile_candidates` takes the
kernels for CUDA tensors (they launch or raise) and the chain for CPU
tensors. Both compute each splat's box with the same f32 operations in the
same order (the rotation columns and the camera-space products written out,
:func:`~rtgs_tpu_torch.utils.quaternion.rotation_columns`,
:func:`_camera_dot`; the kernels are built without FMA contraction) and
keep the live pairs in the same relative order before one stable sort, so
they return the same ``TileBinning``, bitwise.

The JAX version's compile-time workarounds have direct torch forms: its
blocked ``_tree_cumsum`` is ``torch.cumsum``, and its vmapped
``dynamic_slice`` rows are one index gather. The gather-form gradient plan
(``GradPlan``) is not ported: it is off by default there and measured a net
loss.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.camera import Camera
from rtgs_tpu_torch.ops._launch import Launcher, check_tensors
from rtgs_tpu_torch.utils import profiling
from rtgs_tpu_torch.utils.quaternion import \
    rotation_columns as _rotation_columns

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


@dataclasses.dataclass(frozen=True)
class _Layout:
    """The binning's sizes, from the camera and the budgets: the tile grid,
    the local fan-out (``mtx`` × ``mty`` tiles), the narrow class's width,
    the wide class's slots a splat (0: no wide class) and budget, the key
    form (``shift`` 65536 packs the quantised depth under the tile, 1 keys
    the tile alone) and the row width."""

    w: int
    h: int
    tw: int
    th: int
    ntx: int
    nty: int
    mtx: int
    mty: int
    narrow: int
    wide_slots: int
    wlimit: int
    shift: int
    total_c: int

    @property
    def num_tiles(self) -> int:
        return self.ntx * self.nty


def _layout(n: int, camera: Camera, tile, max_candidates: int,
            max_tiles_local, max_global: int, narrow: int | None,
            chunk: int | None) -> _Layout:
    w, h = camera.buf_size
    tw, th = tile
    ntx, nty = -(-w // tw), -(-h // th)
    if max_tiles_local is None:
        max_tiles_local = (min(max(2, -(-128 // tw)), ntx),
                           min(max(2, -(-128 // th)), nty))
    mtx, mty = max_tiles_local
    narrow = min(4 if narrow is None else narrow, mtx, mty)
    # With more tiles than a packed int32 key can hold, keys carry the tile
    # only: drop order within a tile becomes arbitrary and chunk_lb is 0.
    shift = 65536 if ntx * nty <= (1 << 15) - 1 else 1
    total_c = max_candidates + max_global
    if chunk:
        total_c += (-total_c) % chunk
    return _Layout(w, h, tw, th, ntx, nty, mtx, mty, narrow,
                   mtx * mty if mtx > narrow or mty > narrow else 0,
                   max(64, n // 16), shift, total_c)


def _camera_dot(d, col):
    """One camera-space coordinate ``(d₀·c₀ + d₁·c₁) + d₂·c₂`` of world
    offsets ``d`` (three tensors) against a camera rotation column: the
    three-term sum of ``Rᵀ (p − pos)``, in one fixed order (a matrix
    product's summation order is the library's)."""
    return (d[0] * col[0] + d[1] * col[1]) + d[2] * col[2]


def _divisor(x: float, device) -> torch.Tensor:
    """``x`` as a 0-dim f32 tensor on ``device``, to divide by: a Python
    number divides a CUDA tensor as a multiplication by its rounded
    reciprocal, which the CPU and the kernels do not round alike."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def _splat_boxes(g: G.Gaussians, camera: Camera, pad_px: float,
                 lay: _Layout):
    """Per splat: live, behind the camera plane, the tile rectangle (tx0,
    ty0, wx, wy; int32) and the entry-depth lower bound lb (f32): the plain
    version of ``binning.cu``'s splat pass."""
    # 3σ AABB from the principal axes μ ± 3·sᵢ·(R eᵢ).
    rc = _rotation_columns(g.quats)
    s = g.scales.unbind(-1)
    m = g.means.unbind(-1)
    lo, hi = [], []
    for j in range(3):
        ext = torch.maximum(
            torch.maximum(torch.abs(rc[0][j] * s[0]),
                          torch.abs(rc[1][j] * s[1])),
            torch.abs(rc[2][j] * s[2])) * G.BOUNDING_THRESHOLD
        lo.append(m[j] - ext)
        hi.append(m[j] + ext)
    # The 8 corners in camera space: per axis the two offsets from the
    # camera, each axis's products once, summed corner by corner.
    cc = _rotation_columns(camera.rotation)
    pos = camera.position
    d = [torch.stack([lo[j] - pos[j], hi[j] - pos[j]], dim=-1)
         for j in range(3)]                                     # (N, 2)
    pc = [(d[0][:, :, None, None] * cc[k][0]
           + d[1][:, None, :, None] * cc[k][1])
          + d[2][:, None, None, :] * cc[k][2] for k in range(3)]  # (N,2,2,2)
    pc = [p.reshape(-1, 8) for p in pc]
    z = pc[2]
    eps = 1e-6
    behind = torch.any(z > -eps, dim=-1)
    zsafe = torch.clamp(z, max=-eps)
    fx, fy = camera.focal_length[0], camera.focal_length[1]
    # Pixel-center coordinates: pixel i's ray is at px == i.
    px = fx * pc[0] / (-zsafe) + (lay.w / 2 - 0.5)
    py = fy * pc[1] / (-zsafe) + (lay.h / 2 - 0.5)
    px_min, px_max = px.amin(-1) - pad_px, px.amax(-1) + pad_px
    py_min, py_max = py.amin(-1) - pad_px, py.amax(-1) + pad_px

    off_screen = ((px_max < -0.5) | (px_min > lay.w - 0.5)
                  | (py_max < -0.5) | (py_min > lay.h - 0.5))
    live = (g.mask > 0) & (behind | ~off_screen)

    def tile_of(v, nt, t):
        return torch.clamp(torch.floor(v / _divisor(t, v.device)), 0,
                           nt - 1).to(torch.int32)

    tx0, tx1 = tile_of(px_min, lay.ntx, lay.tw), tile_of(px_max, lay.ntx,
                                                          lay.tw)
    ty0, ty1 = tile_of(py_min, lay.nty, lay.th), tile_of(py_max, lay.nty,
                                                          lay.th)
    # Quantized entry-depth lower bound's source: center depth − √3·s_max.
    depth = -_camera_dot([m[j] - pos[j] for j in range(3)], cc[2])
    lb = torch.clamp(depth - math.sqrt(G.BOUNDING_THRESHOLD)
                     * g.scales.amax(-1), min=0.0)
    return live, behind, tx0, ty0, tx1 - tx0 + 1, ty1 - ty0 + 1, lb


def tile_candidates_torch(
    g: G.Gaussians,
    camera: Camera,
    tile=(16, 16),
    max_candidates: int = 512,
    max_tiles_local=None,
    max_global: int = 128,
    pad_px: float = 0.0,
    narrow: int | None = None,
    chunk: int | None = None,
    entry_lb: torch.Tensor | None = None,
) -> TileBinning:
    """Plain version of :func:`tile_candidates` (same arguments and result)
    in torch operations on any device: the fan-out of every (tile, splat)
    slot, one stable sort of all of them and a gather. What the CPU runs,
    and what the kernels are held to on the card."""
    n = g.num
    lay = _layout(n, camera, tile, max_candidates, max_tiles_local,
                  max_global, narrow, chunk)
    ntx, nty, num_tiles = lay.ntx, lay.nty, lay.num_tiles
    mtx, mty, narrow = lay.mtx, lay.mty, lay.narrow
    shift = lay.shift
    packed_key = shift > 1
    dev = g.device
    i32 = torch.int32

    live, behind, tx0, ty0, wx, wy, lb = _splat_boxes(g, camera, pad_px, lay)
    is_global = live & (behind | (wx > mtx) | (wy > mty))
    is_local = live & ~is_global

    # --- The quantized bound is the in-tile sort key, the drop order and
    # the kernel's early-exit bound. Truncation rounds down, so the
    # dequantized bound stays ≤ t1. The clamp to 65534 keeps the farthest
    # global pair's key below the dead-slot sentinel INT32_MAX at
    # num_tiles == 32767. ---
    dmax = torch.clamp(torch.where(live, lb, 0.0).amax(), min=1e-6)
    dq = torch.clamp(lb / dmax * 65535.0, 0, 65534).to(i32)

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
    if lay.wide_slots:
        # Compact the wide splats (in id order) to a budget, then fan each
        # out over the full rectangle; slot ``wlimit`` takes the rest and is
        # cut off.
        wlimit = lay.wlimit
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
    total_c = lay.total_c

    # Row t = [global list | tile t's pairs], one gather from the stream.
    j = torch.arange(total_c, dtype=i32, device=dev)[None, :]
    lj = j - n_glob
    ok = (j < n_glob) | ((lj >= 0) & (lj < cl[:, None]))
    src = torch.where(j < n_glob, offs[num_tiles] + j,
                      offs[:num_tiles, None] + lj)
    src = torch.clamp(src, 0, key_s.shape[0] - 1).long()
    cand_ids = val_s[src]
    candidates = torch.where(ok, cand_ids, -1)
    local_overflow = torch.clamp(tcounts[:num_tiles] - max_candidates,
                                 min=0).sum()
    global_overflow = torch.clamp(tcounts[num_tiles] - max_global, min=0)
    counts = cl + n_glob

    chunk_lb = None
    if chunk:
        nchunk = total_c // chunk
        if packed_key:
            # Per splat the sort key's depth, dequantised (what the key's
            # low 16 bits hold), then one gather through the slots' ids.
            lb_splat = dq.float() * (dmax / _divisor(65535.0, dev))
            if entry_lb is not None:
                lb_splat = torch.minimum(lb_splat, entry_lb)
            lb_slot = torch.where(ok, lb_splat[cand_ids], math.inf)
            cmin = lb_slot.reshape(num_tiles, nchunk, chunk).amin(2)
            chunk_lb = torch.cummin(cmin.flip(1), dim=1).values.flip(1)
        else:
            chunk_lb = torch.zeros((num_tiles, nchunk), device=dev)
        chunk_lb = torch.cat(
            [chunk_lb, torch.zeros((num_tiles, 1), device=dev)], dim=1)
    return TileBinning(candidates, ntx, nty, local_overflow, global_overflow,
                       counts, chunk_lb)


_COUNT = Launcher("rtgs_binning_count", "binning count")
_SCRATCH_INTS = Launcher("rtgs_binning_scratch_ints", "binning scratch size")
_PAIR_INTS = Launcher("rtgs_binning_pair_ints", "binning sort size")
_ROWS = Launcher("rtgs_binning_rows", "binning rows")


def _ints(launcher: Launcher, dev: torch.device, *args) -> int:
    """A size in int32 that ``binning.cu``, which alone lays its buffers
    out, computes on the host (the call launches nothing)."""
    out = ctypes.c_longlong(0)
    launcher(dev, *args, ctypes.addressof(out))
    return out.value


def tile_candidates_cuda(
    g: G.Gaussians,
    camera: Camera,
    tile=(16, 16),
    max_candidates: int = 512,
    max_tiles_local=None,
    max_global: int = 128,
    pad_px: float = 0.0,
    narrow: int | None = None,
    chunk: int | None = None,
    entry_lb: torch.Tensor | None = None,
) -> TileBinning:
    """:func:`tile_candidates` through the Hopper kernels
    (``csrc/binning.cu``) on the current stream: two launching calls into
    the library around one read of the live-pair count, which sizes the
    sort (and two queries of the buffers' sizes, which launch nothing).

    The first call runs the splat pass (box, class, bound, each block's wide
    count and largest bound), the wide ranks and dmax, each block's live
    pairs a slot row, and their scan; the second writes each live pair's
    (key, id) at its place in the plain version's slot order, sorts them
    once with the library's stable radix sort (CUB, over the key's bits
    only), marks each tile's segment and writes the rows, ``counts``, the
    overflow sums and ``chunk_lb``. Same arguments and result as
    :func:`tile_candidates_torch`, bitwise. Every input must be a CUDA
    tensor on one device; a failed build or launch raises.
    ``tile_candidates_cuda.launches`` counts the calls."""
    n = g.num
    lay = _layout(n, camera, tile, max_candidates, max_tiles_local,
                  max_global, narrow, chunk)
    f32 = torch.float32
    ins = [("means", g.means, (n, 3)), ("quats", g.quats, (n, 4)),
           ("scales", g.scales, (n, 3)), ("mask", g.mask, (n,)),
           ("position", camera.position, (3,)),
           ("rotation", camera.rotation, (4,)),
           ("focal_length", camera.focal_length, (2,))]
    if entry_lb is not None:
        ins.append(("entry_lb", entry_lb, (n,)))
    specs = [(name, x.detach().contiguous(), f32, shape)
             for name, x, shape in ins]
    dev = check_tensors("tile_candidates_cuda", specs)
    x = {name: t for name, t, _, _ in specs}
    if max(lay.mtx, lay.mty) >= 1 << 14:
        raise ValueError(f"tile_candidates_cuda: a fan-out of {lay.mtx} x "
                         f"{lay.mty} tiles is past the kernels' 16,383")
    slots = lay.narrow * lay.narrow + lay.wide_slots + 1
    num_tiles, total_c = lay.num_tiles, lay.total_c
    nchunk = total_c // chunk if chunk else 0
    sbits = 16 if lay.shift > 1 else 0
    scratch = torch.empty(_ints(_SCRATCH_INTS, dev, n, slots),
                          dtype=torch.int32, device=dev)
    _COUNT(dev, x["means"].data_ptr(), x["quats"].data_ptr(),
           x["scales"].data_ptr(), x["mask"].data_ptr(),
           x["position"].data_ptr(), x["rotation"].data_ptr(),
           x["focal_length"].data_ptr(), scratch.data_ptr(), n, lay.w, lay.h,
           lay.tw, lay.th, lay.ntx, lay.nty, lay.mtx, lay.mty, lay.narrow,
           lay.wide_slots, lay.wlimit, float(pad_px))
    # The one host synchronisation: the live pairs size the sort.
    live = int(scratch[1])
    pairs = torch.empty(_ints(_PAIR_INTS, dev, live, num_tiles, sbits),
                        dtype=torch.int32, device=dev)
    candidates = torch.empty((num_tiles, total_c), dtype=torch.int32,
                             device=dev)
    counts = torch.empty(num_tiles, dtype=torch.int32, device=dev)
    local_overflow = torch.empty((), dtype=torch.int64, device=dev)
    global_overflow = torch.empty((), dtype=torch.int32, device=dev)
    chunk_lb = (torch.empty((num_tiles, nchunk + 1), dtype=f32, device=dev)
                if chunk else None)
    lb_in = x.get("entry_lb")
    _ROWS(dev, scratch.data_ptr(), pairs.data_ptr(),
          None if lb_in is None else lb_in.data_ptr(),
          candidates.data_ptr(), counts.data_ptr(),
          local_overflow.data_ptr(), global_overflow.data_ptr(),
          None if chunk_lb is None else chunk_lb.data_ptr(), n, slots,
          lay.narrow, lay.wide_slots, lay.mty, lay.nty, num_tiles, sbits,
          live, max_candidates, max_global, total_c, chunk or 0)
    tile_candidates_cuda.launches += 1
    return TileBinning(candidates, lay.ntx, lay.nty, local_overflow,
                       global_overflow, counts, chunk_lb)


tile_candidates_cuda.launches = 0


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
    entry_lb: torch.Tensor | None = None,
) -> TileBinning:
    """Build fixed-width per-tile candidate lists on the scene's device:
    the kernels (:func:`tile_candidates_cuda`) for CUDA tensors, which
    launch or raise, and the plain chain (:func:`tile_candidates_torch`)
    for CPU tensors; the same inputs give the same bits on either.

    ``max_tiles_local`` defaults to ~128 px of screen coverage per axis;
    wider splats go to the global list. ``narrow`` (default 4) is the
    narrow-class fan-out width in tiles: splats covering at most
    ``narrow × narrow`` tiles fan out to that many slots, the rarer wide
    ones are compacted to a budget of ``max(64, N/16)`` and fan out to the
    full ``max_tiles_local`` rectangle, and wide splats beyond the budget
    spill to the global list. ``chunk``: pad the candidate width to a
    multiple of it and return ``chunk_lb``. ``pad_px`` widens every
    projected box (subpixel jitter). ``entry_lb``: per splat (N,) f32, a
    proven lower bound of the entry depths the feature table gives
    (:func:`rtgs_tpu_torch.render.tiled.entry_lower_bound`); ``chunk_lb``
    then takes the smaller of it and the sort key's depth, which bounds the
    exact ellipsoid but not the table's rounding of it. The candidate order
    does not depend on it.
    """
    impl = (tile_candidates_torch if g.device.type == "cpu"
            else tile_candidates_cuda)
    b = impl(g, camera, tile=tile, max_candidates=max_candidates,
             max_tiles_local=max_tiles_local, max_global=max_global,
             pad_px=pad_px, narrow=narrow, chunk=chunk, entry_lb=entry_lb)
    # The binning's work and its losses, for a profiled window: the live
    # (tile, splat) pairs and those the budgets dropped.
    profiling.count("binning.live_pairs", b.counts)
    profiling.count("binning.dropped_pairs", b.local_overflow)
    profiling.count("binning.dropped_pairs", b.global_overflow)
    return b
