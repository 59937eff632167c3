"""Tile top-K peels (port of :mod:`rtgs_tpu.ops.peel`): the keys-only
top-K, per pixel the K nearest ``(t1, splat id)`` among its tile's
candidates; the fused-payload peel, which also shades and composites the
K nearest and has a hand-written backward (see :func:`peel_fused`); and
the top-K peel, which shades the K nearest and returns them uncomposited,
also with a hand-written backward (see :func:`peel_topk`).

Feature packing (F = 64 lanes), as in the JAX package:
  [0:6]   Σ⁻¹ packed sym6 (m00, m01, m02, m11, m12, m22)
  [6:9]   Me, e = origin − μ
  [9]     c0 = eᵀMe − 3
  [10]    opacity
  [11:14] base color rgb
  [14:29] SH·r   [29:44] SH·g   [44:59] SH·b
Pixel packing (G = 24 lanes): [0:3] dir, [3:9] d-quadratic features
(dx², 2dxdy, 2dxdz, dy², 2dydz, dz²), [9:24] SH basis y(dir).

Entry depth: A = fd·m6, B = 2 d·Me, Δ = B² − 4A·c0,
t1 = (−B − √max(Δ, 0)) / 2A; a candidate hits iff Δ ≥ 0 and t1 > 0. The
chain runs in float64 from the f32 tables (see :func:`entry_depth`); the
JAX package runs it in f32. Ordering is lexicographic on (t1, id): among
equal t1 the lower splat id wins. Results are (T, K, P): t1 f32 (+inf
vacant) and sid int32 (−1 vacant; the JAX package uses f32 +inf).

Each kernel has two implementations with one contract: the hand-written
Hopper kernel (``csrc/keys.cu``: :func:`peel_keys_cuda`; ``csrc/peel_fwd.cu``
and ``csrc/peel_bwd.cu``: :func:`peel_fused_cuda`, :func:`peel_fused_bwd_cuda`;
``csrc/peel_topk_fwd.cu`` and ``csrc/peel_topk_bwd.cu``:
:func:`peel_topk_cuda`, :func:`peel_topk_bwd_cuda`) and its plain torch twin
(:func:`peel_keys_torch`, :func:`peel_fused_torch`,
:func:`peel_fused_bwd_torch`, :func:`peel_topk_torch`,
:func:`peel_topk_bwd_torch`). Both evaluate t1 with the same operations in
the same order, and the kernels are built without FMA contraction, so on
the card the two select the same winners bitwise. The three forward
kernels put an f32 screen in front of the float64 chain (plain version:
:func:`screen_margin`, :func:`screen_rejects`), which rejects only pairs
whose float64 Δ is negative and so changes no bit. Every wrapper goes
through one launch path (:mod:`rtgs_tpu_torch.ops._launch`).

Every backward is two deterministic stages, as the JAX package's: stage 1
sums each (tile, candidate slot) pair's gradient row over the tile's pixels
(the backward kernels write one row a swept slot into a compacted buffer,
:func:`pair_layout`; their twins return per-slot rows (T, C, 64)); stage 2
sums each splat's rows into the (N+1, 64) table in row order
(``csrc/segment_rows.cu``: :func:`segment_rows_cuda`; plain version
:func:`segment_rows_torch`). No float atomic and no ``index_add_`` on the
card: gradients are bitwise repeatable. The dispatchers (:func:`peel_keys`,
:func:`peel_fused`, :func:`peel_topk`, :func:`segment_rows`) pick by the
tensors' device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from rtgs_tpu_torch.ops._launch import Launcher, check_tensors

F_DIM = 64
G_DIM = 24
# Candidate-chunk width of the kernel's sweep; the binning's chunk_lb must
# be built at this width.
CHUNK = 128
# The kernel keeps each pixel's list in registers, instantiated for these
# capacities (csrc/keys.cu).
MAX_DEPTH = 64
# Pixels a backward block takes at once (csrc/peel_common.cuh, kThreads):
# a tile of more pixels is contracted group after group.
PIXEL_GROUP = 256
_INT32_MAX = 2**31 - 1


def _counts(candidates: torch.Tensor) -> torch.Tensor:
    """Per-tile candidate count = last valid slot + 1 (int32)."""
    lane = torch.arange(1, candidates.shape[1] + 1, dtype=torch.int32,
                        device=candidates.device)
    return torch.where(candidates >= 0, lane, 0).amax(dim=1).to(torch.int32)


def entry_depth(rows: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """Entry depths t1 (T, P, C) f32 of feature rows (T, C, ≥10) f32
    against pixel features (T, P, 24) f32, +inf on a miss.

    The chain runs in float64 from the f32 inputs and t1 is rounded to f32
    once: B² and 4A·c0 agree to ~1/|Σ^-½e|² and cancel in Δ, so an f32
    chain loses up to ~1e-3 of t1 at bench splat sizes. Operations and their
    order are the kernel's (A summed over j = 0..5, then B, then
    Δ = B·B − (4·A)·c0)."""
    m = rows[:, None, :, :10].double()   # (T, 1, C, 10)
    q = pix[:, :, None, :9].double()     # (T, P, 1, 9)
    a = q[..., 3] * m[..., 0]
    for j in range(1, 6):
        a = a + q[..., 3 + j] * m[..., j]
    b = q[..., 0] * m[..., 6]
    for j in range(1, 3):
        b = b + q[..., j] * m[..., 6 + j]
    b = 2.0 * b
    delta = b * b - (4.0 * a) * m[..., 9]
    sq = torch.sqrt(torch.where(delta > 0, delta, 0.0))
    t1 = (-b - sq) / (2.0 * a)
    return torch.where((delta >= 0) & (t1 > 0), t1, math.inf).float()


# The screen's constants (csrc/peel_common.cuh, where the bound is derived):
# 12·2⁻²⁴ of b̄² + Ā|c0|, 2⁻¹⁴⁶ of |c0| + b̄ + 1 for gradual underflow, and no
# rejection at all once b̄² + Ā|c0| reaches 2¹²⁰.
SCREEN_REL = 12.0 * 2.0**-24
SCREEN_TINY = 2.0**-146
SCREEN_MAX = 2.0**120


def screen_margin(rows: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """The sweeps' screen margin (T, C) f32 of feature rows
    (T, C, ≥10) f32 against the pixels (T, P, 24) f32 of their tile: a bound
    of the error of an f32 evaluation of Δ/4 = b² − A·c0 (b = d·Me, A =
    fd·m6), from the tile's largest |d_j| and |fd_j| and the row's |m_j|,
    |Me_j| and |c0|: ``SCREEN_REL·(b̄² + Ā·|c0|) + SCREEN_TINY·(|c0| + b̄ +
    1)`` with Ā and b̄ the sums of absolute products; +inf where b̄² + Ā·|c0|
    is not below ``SCREEN_MAX`` (or is NaN), so that nothing there is
    rejected. Plain version of ``screen_margin`` in
    ``csrc/peel_common.cuh``; f32 throughout."""
    mx = pix[..., :9].abs().amax(dim=1)[:, None, :]    # (T, 1, 9)
    m = rows[..., :10].abs()
    abar = mx[..., 3] * m[..., 0]
    for j in range(1, 6):
        abar = abar + mx[..., 3 + j] * m[..., j]
    bbar = mx[..., 0] * m[..., 6]
    for j in range(1, 3):
        bbar = bbar + mx[..., j] * m[..., 6 + j]
    c0 = m[..., 9]
    s = bbar * bbar + abar * c0
    margin = SCREEN_REL * s + SCREEN_TINY * ((c0 + bbar) + 1.0)
    return torch.where(s < SCREEN_MAX, margin, math.inf)


def screen_rejects(rows: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """Whether the sweeps' screen rejects each (pixel, candidate)
    pair, (T, P, C) bool: the f32 Δ/4 lies below −:func:`screen_margin`. It
    is never true where :func:`entry_depth` finds a hit (the margin bounds
    the f32 error, fused or not), and a NaN on either side compares false.
    Plain version of ``screen_rejects`` in ``csrc/peel_common.cuh``; used by
    the tests, by nothing on the card's path."""
    m = rows[:, None, :, :10]                          # (T, 1, C, 10)
    q = pix[:, :, None, :9]                            # (T, P, 1, 9)
    a = q[..., 3] * m[..., 0]
    for j in range(1, 6):
        a = a + q[..., 3 + j] * m[..., j]
    b = q[..., 0] * m[..., 6]
    for j in range(1, 3):
        b = b + q[..., j] * m[..., 6 + j]
    quarter_delta = b * b - a * m[..., 9]
    return quarter_delta < -screen_margin(rows, pix)[:, None, :]


def peel_keys_torch(packed: torch.Tensor, candidates: torch.Tensor,
                    pix: torch.Tensor, depth: int):
    """Plain twin of the keys kernel: gather the candidates' rows, evaluate
    the whole (T, P, C) t1 field, and sort it lexicographically by
    (t1, id) — candidates are stable-sorted by id once, then the field is
    stable-sorted by t1. Returns (t1, sid), each (T, K, P)."""
    ids, _ = torch.sort(torch.where(candidates >= 0, candidates, _INT32_MAX),
                        dim=1, stable=True)
    n_sentinel = packed.shape[0] - 1
    rows = packed[:, :10][torch.where(ids < _INT32_MAX, ids, n_sentinel)]
    t1 = entry_depth(rows, pix)                        # (T, P, C)
    if t1.shape[2] < depth:
        t1 = F.pad(t1, (0, depth - t1.shape[2]), value=math.inf)
        ids = F.pad(ids, (0, depth - ids.shape[1]), value=_INT32_MAX)
    t1_s, order = torch.sort(t1, dim=2, stable=True)
    t1_k = t1_s[..., :depth]
    sid_k = ids[:, None, :].expand(t1.shape).gather(2, order[..., :depth])
    # A miss still carries its candidate's id through the sort.
    sid_k = torch.where(torch.isfinite(t1_k), sid_k, -1)
    return (t1_k.transpose(1, 2).contiguous(),
            sid_k.transpose(1, 2).contiguous())


def _check_launch(who: str, specs, c: int, p: int, depth: int):
    """Common input checks of the kernel wrappers: ``specs`` as
    :func:`~rtgs_tpu_torch.ops._launch.check_tensors` takes them, then the
    candidate width, list capacity and tile size the kernels are built
    for. Returns the tensors' device."""
    dev = check_tensors(who, specs)
    if c % CHUNK != 0:
        raise ValueError(f"{who}: candidate width {c} is not a multiple of "
                         f"{CHUNK}")
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"{who}: depth {depth} outside 1..{MAX_DEPTH}")
    if not 1 <= p <= 1024:
        raise ValueError(f"{who}: {p} pixels per tile; one block holds "
                         "≤ 1024")
    return dev


_KEYS = Launcher("rtgs_keys_sid", "keys")
_FUSED_FWD = Launcher("rtgs_peel_fwd", "fused forward")
_FUSED_BWD = Launcher("rtgs_peel_bwd", "fused backward")
_TOPK_FWD = Launcher("rtgs_peel_topk_fwd", "top-K forward")
_TOPK_BWD = Launcher("rtgs_peel_topk_bwd", "top-K backward")
_SEGMENT = Launcher("rtgs_segment_rows", "segment rows")


def peel_keys_cuda(packed: torch.Tensor, candidates: torch.Tensor,
                   counts: torch.Tensor, chunk_lb: torch.Tensor,
                   pix: torch.Tensor, depth: int,
                   screen_counts: torch.Tensor | None = None):
    """Launch the Hopper keys kernel (``csrc/keys.cu``) on the current
    stream.

    Args:
      packed: (N+1, 64) f32 feature table; row N is the sentinel.
      candidates: (T, C) int32 ids, −1 padded, C a multiple of ``CHUNK``.
      counts: (T,) int32 swept prefix length per tile (:func:`_counts`).
      chunk_lb: (T, C/CHUNK + 1) f32 entry-depth suffix bounds from
        ``tile_candidates(..., chunk=CHUNK)``; zeros disable the early exit.
      pix: (T, P, 24) f32 pixel features, P ≤ 1024.
      depth: K, 1..``MAX_DEPTH``.
      screen_counts: None, or a (2,) int64 tensor into which the kernel adds
        the (pixel, live candidate) pairs it evaluated and those its f32
        screen rejected before the float64 chain (another instantiation of
        the kernel: the one without counters is the one to time).

    Returns (t1 (T, K, P) f32, sid (T, K, P) int32). Every input must be a
    contiguous CUDA tensor on one device; a failed build or launch raises.
    ``peel_keys_cuda.launches`` counts the launches.
    """
    t, c = candidates.shape
    p = pix.shape[1]
    specs = [
        ("packed", packed, torch.float32, (packed.shape[0], F_DIM)),
        ("candidates", candidates, torch.int32, (t, c)),
        ("counts", counts, torch.int32, (t,)),
        ("chunk_lb", chunk_lb, torch.float32, (t, c // CHUNK + 1)),
        ("pix", pix, torch.float32, (t, p, G_DIM))]
    if screen_counts is not None:
        specs.append(("screen_counts", screen_counts, torch.int64, (2,)))
    dev = _check_launch("peel_keys_cuda", specs, c, p, depth)

    # One allocation for both outputs (it saves the host one allocation a
    # call): sid is the second half viewed as int32, so either output keeps
    # both alive.
    out = torch.empty((2, t, depth, p), dtype=torch.float32, device=dev)
    t1, sid = out[0], out[1].view(torch.int32)
    if t == 0:
        return t1, sid
    _KEYS(dev, packed.data_ptr(), candidates.data_ptr(), counts.data_ptr(),
          chunk_lb.data_ptr(), pix.data_ptr(), t1.data_ptr(), sid.data_ptr(),
          None if screen_counts is None else screen_counts.data_ptr(),
          t, c, p, depth)
    peel_keys_cuda.launches += 1
    return t1, sid


peel_keys_cuda.launches = 0


def peel_keys(packed: torch.Tensor, candidates: torch.Tensor,
              pix: torch.Tensor, depth: int, impl: str = "auto",
              chunk_lb: torch.Tensor | None = None,
              counts: torch.Tensor | None = None):
    """Keys-only top-K dispatcher. Index selection has no gradient, so the
    inputs are detached.

    ``impl``: ``"auto"`` (the kernel for CUDA tensors, the twin for CPU
    tensors), ``"cuda"`` or ``"torch"``. ``chunk_lb`` enables the kernel's
    exact early exit; the twin sorts everything and ignores it. ``counts``:
    the binning's (T,) int32 valid-prefix lengths where the caller has them
    (else a pass over ``candidates`` finds them). Returns (t1, sid), each
    (T, K, P)."""
    packed, pix = packed.detach(), pix.detach()
    if impl not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown keys impl {impl!r}")
    if impl == "torch" or (impl == "auto" and packed.device.type == "cpu"):
        return peel_keys_torch(packed, candidates, pix, depth)
    t, c = candidates.shape
    if chunk_lb is None:
        chunk_lb = torch.zeros((t, c // CHUNK + 1), device=packed.device)
    if counts is None:
        counts = _counts(candidates)
    return peel_keys_cuda(packed, candidates, counts.contiguous(),
                          chunk_lb.detach().contiguous(), pix, depth)


# ---------------------------------------------------------------------------
# Stage 2 of every backward: the ordered, atomic-free sum of gradient rows
# by splat (the counterpart of the JAX backwards' jax.ops.segment_sum).
# ---------------------------------------------------------------------------

def segment_rows_torch(rows: torch.Tensor, ids: torch.Tensor,
                       n_out: int) -> torch.Tensor:
    """Plain version of ``csrc/segment_rows.cu``: ``out[ids[i]] += rows[i]``
    into ``n_out`` zero rows, with ``index_add_``; ids outside [0,
    ``n_out``) are skipped, as the kernel skips them. On the CPU
    ``index_add_`` adds row by row in ascending i, the kernel's order, so
    the two agree bitwise; on the card it adds in no fixed order, and
    nothing of the port calls this there (:func:`segment_rows` launches the
    kernel)."""
    keep = (ids >= 0) & (ids < n_out)
    if not bool(keep.all()):
        rows, ids = rows[keep], ids[keep]
    return torch.zeros((n_out,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                       device=rows.device).index_add_(0, ids.long(), rows)


def segment_rows_cuda(rows: torch.Tensor, ids: torch.Tensor,
                      n_out: int) -> torch.Tensor:
    """Launch the Hopper segment sum (``csrc/segment_rows.cu``) on the
    current stream: ``out[r] = Σ rows[i]`` over the i with ``ids[i] = r``,
    in ascending i, f32 adds from 0, every row of ``out`` written once (zero
    where no id names it); ids outside [0, ``n_out``) are skipped.

    Args:
      rows: (M, 64) f32.
      ids: (M,) int32.
      n_out: rows of the result, at least 1.

    The grouping by id is ``torch.sort(ids, stable=True)`` (the kernel walks
    each id's run in the order the stable sort keeps); no atomic of any
    kind, so the result is bitwise repeatable and bitwise
    :func:`segment_rows_torch` on the CPU. Every input must be a contiguous
    CUDA tensor on one device; a failed build or launch raises.
    ``segment_rows_cuda.launches`` counts the launches."""
    m = rows.shape[0]
    dev = check_tensors("segment_rows_cuda", (
        ("rows", rows, torch.float32, (m, F_DIM)),
        ("ids", ids, torch.int32, (m,))))
    if n_out < 1:
        raise ValueError(f"segment_rows_cuda: n_out {n_out} < 1")
    sorted_ids, perm = torch.sort(ids, stable=True)
    starts = torch.empty(n_out + 1, dtype=torch.int32, device=dev)
    out = torch.empty((n_out, F_DIM), dtype=torch.float32, device=dev)
    _SEGMENT(dev, rows.data_ptr(), sorted_ids.data_ptr(), perm.data_ptr(),
             starts.data_ptr(), out.data_ptr(), m, n_out)
    segment_rows_cuda.launches += 1
    return out


segment_rows_cuda.launches = 0


def segment_rows(rows: torch.Tensor, ids: torch.Tensor,
                 n_out: int) -> torch.Tensor:
    """``out[ids[i]] += rows[i]`` into ``n_out`` zero rows (64 lanes), each
    row of ``out`` summed in ascending i: :func:`segment_rows_torch` for CPU
    tensors, the kernel (:func:`segment_rows_cuda`) for CUDA tensors, which
    launches or raises. The same inputs give the same bits on either, run
    after run."""
    if rows.device.type == "cpu":
        return segment_rows_torch(rows, ids, n_out)
    return segment_rows_cuda(rows.contiguous(),
                             ids.to(torch.int32).contiguous(), n_out)


def pair_layout(counts: torch.Tensor):
    """Layout of the backward kernels' compacted per-pair buffer: one row a
    swept (tile, slot) pair, tile by tile, slots ascending (the first
    ``counts[t]`` slots of tile t; the rest of C is padding, which never
    wins); the kernels write each row's splat id, ``candidates[t, slot]``
    (−1 for an interior gap, whose row is zero and which
    :func:`segment_rows` skips). Returns (pair_base (T,) int32, each tile's
    first row: the exclusive prefix sum of ``counts``; M = Σ counts, read
    to the host to size the buffer)."""
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    m = int(ends[-1]) if ends.numel() else 0
    return (ends - counts).contiguous(), m


# ---------------------------------------------------------------------------
# Fused-payload peel: select, shade and composite the K nearest, with a
# hand-written backward (port of rtgs_tpu.ops.peel.peel_pallas).
# ---------------------------------------------------------------------------

def _safe_ids(packed: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """Candidate ids with −1 mapped to the sentinel row N (int64)."""
    return torch.where(candidates >= 0, candidates,
                       packed.shape[0] - 1).long()


def _select(packed: torch.Tensor, candidates: torch.Tensor,
            pix: torch.Tensor, depth: int):
    """The K nearest hits' t1 (T, K, P) f32 (+inf vacant) and candidate
    slots (T, K, P) int32 (−1 vacant); see :func:`select_slots`."""
    rows = packed[:, :10][_safe_ids(packed, candidates)]
    t1 = entry_depth(rows, pix)                        # (T, P, C)
    if t1.shape[2] < depth:
        t1 = F.pad(t1, (0, depth - t1.shape[2]), value=math.inf)
    t1_s, order = torch.sort(t1, dim=2, stable=True)
    t1_k = t1_s[..., :depth]
    slots = torch.where(torch.isfinite(t1_k), order[..., :depth], -1)
    return (t1_k.transpose(1, 2).contiguous(),
            slots.transpose(1, 2).to(torch.int32).contiguous())


def select_slots(packed: torch.Tensor, candidates: torch.Tensor,
                 pix: torch.Tensor, depth: int) -> torch.Tensor:
    """Candidate slots (T, K, P) int32 of each pixel's K nearest hits,
    ordered lexicographically by (t1, slot): the field is stable-sorted by
    t1 along the slot axis, so among equal t1 the earlier slot wins, as in
    the JAX ``_merge_topk``. −1 marks a vacant layer."""
    return _select(packed, candidates, pix, depth)[1]


def _winner_rows(packed: torch.Tensor, candidates: torch.Tensor,
                 slots: torch.Tensor) -> torch.Tensor:
    """Feature rows (T, K, P, 64) of the winners at ``slots``; vacant
    layers read the sentinel row. Differentiable in ``packed``."""
    t, k, p = slots.shape
    ids = candidates.gather(1, slots.clamp(min=0).reshape(t, k * p).long())
    ids = torch.where(slots.reshape(t, k * p) >= 0, ids, -1)
    return packed[_safe_ids(packed, ids).reshape(t, k, p)]


def _shade_layers(rows: torch.Tensor, pix: torch.Tensor,
                  won: torch.Tensor):
    """f32 shading of the (T, K, P) winners: the quadratic (a, b), the
    response ρ = exp(B²/4A − (c0+3)) where Δ > 0 (else 0; a tangent winner
    keeps its layer with α = 0), α = op·ρ, and rgb = color + y·SH. The
    operations and their order are the kernels'."""
    def pf(j):
        return pix[:, None, :, j]                      # (T, 1, P)

    a = pf(3) * rows[..., 0]
    for j in range(1, 6):
        a = a + pf(3 + j) * rows[..., j]
    b = pf(0) * rows[..., 6]
    for j in range(1, 3):
        b = b + pf(j) * rows[..., 6 + j]
    b = 2.0 * b
    cq = rows[..., 9]
    delta = b * b - (4.0 * a) * cq
    rho = torch.exp(torch.where(won & (delta > 0.0),
                                b * b / (4.0 * a) - (cq + 3.0), -math.inf))
    alpha = rows[..., 10] * rho
    rgb = []
    for ch in range(3):
        acc = pf(9) * rows[..., 14 + 15 * ch]
        for j in range(1, 15):
            acc = acc + pf(9 + j) * rows[..., 14 + 15 * ch + j]
        rgb.append(rows[..., 11 + ch] + acc)
    return a, b, rho, alpha, rgb


def peel_fused_torch(packed: torch.Tensor, candidates: torch.Tensor,
                     pix: torch.Tensor, depth: int):
    """Plain twin of the fused forward kernel (the counterpart of the JAX
    ``peel_reference``): select the K nearest by (t1, slot)
    (:func:`select_slots`), shade them in f32 and composite front to back.
    Differentiable in ``packed`` through the shading (the selection is
    piecewise constant). Returns (radiance (T, 3, P), transmittance (T, P),
    slots (T, K, P) int32)."""
    with torch.no_grad():
        slots = select_slots(packed.detach(), candidates, pix.detach(),
                             depth)
    rows = _winner_rows(packed, candidates, slots)
    _, _, _, alpha, rgb = _shade_layers(rows, pix, slots >= 0)
    t, _, p = slots.shape
    rr = rg = rb = torch.zeros((t, p), dtype=packed.dtype,
                               device=packed.device)
    tr = torch.ones_like(rr)
    for k in range(depth):
        a = alpha[:, k]
        w = tr * a
        rr = rr + w * rgb[0][:, k]
        rg = rg + w * rgb[1][:, k]
        rb = rb + w * rgb[2][:, k]
        tr = tr * (1.0 - a)
    return torch.stack([rr, rg, rb], dim=1), tr, slots


def _layer_cotangents(grad_rad, grad_trans, alpha, r, g, b):
    """Per-layer cotangents (T, K, P) from the division-free suffix
    recurrences U = a·c + (1−a)·U, V = (1−a)·V (JAX ``_layer_cotangents``):
    ∂L/∂αₖ = Σ_ch ḡ_ch·Tₖ·(c_ch,k − U_ch) − ḡ_T·Tₖ·Vₖ and the color
    cotangents ḡ_ch·Tₖ·αₖ."""
    gr, gg, gb = grad_rad[:, 0], grad_rad[:, 1], grad_rad[:, 2]
    gt = grad_trans
    depth = alpha.shape[1]
    tks, tr = [], torch.ones_like(gt)
    for k in range(depth):
        tks.append(tr)
        tr = tr * (1.0 - alpha[:, k])
    ur = ug = ub = torch.zeros_like(gt)
    v = torch.ones_like(gt)
    ga, gwr, gwg, gwb = ([None] * depth for _ in range(4))
    for k in range(depth - 1, -1, -1):
        tk, ak = tks[k], alpha[:, k]
        rk, gk, bk = r[:, k], g[:, k], b[:, k]
        ga[k] = (gr * tk * (rk - ur) + gg * tk * (gk - ug)
                 + gb * tk * (bk - ub) - gt * tk * v)
        w = tk * ak
        gwr[k], gwg[k], gwb[k] = gr * w, gg * w, gb * w
        ur = ak * rk + (1.0 - ak) * ur
        ug = ak * gk + (1.0 - ak) * ug
        ub = ak * bk + (1.0 - ak) * ub
        v = (1.0 - ak) * v
    return tuple(torch.stack(x, dim=1) for x in (ga, gwr, gwg, gwb))


def peel_fused_bwd_torch(packed: torch.Tensor, candidates: torch.Tensor,
                         pix: torch.Tensor, slots: torch.Tensor,
                         grad_rad: torch.Tensor,
                         grad_trans: torch.Tensor) -> torch.Tensor:
    """Plain twin of the backward kernel: per-slot feature gradients
    (T, C, 64) of ``Σ grad_rad·radiance + Σ grad_trans·transmittance`` for
    the winners ``slots`` of the forward: the layer cotangents of the
    composite (:func:`_layer_cotangents`), chained to the slots by
    :func:`_slot_grads`."""
    won = slots >= 0
    a, b, rho, alpha, rgb = _shade_layers(
        _winner_rows(packed, candidates, slots), pix, won)
    ga, gwr, gwg, gwb = _layer_cotangents(grad_rad, grad_trans, alpha, *rgb)
    return _slot_grads(candidates, pix, slots, a, b, rho, alpha,
                       ga, gwr, gwg, gwb)


def _slot_grads(candidates, pix, slots, a, b, rho, alpha,
                ga, gwr, gwg, gwb) -> torch.Tensor:
    """Per-slot feature gradients (T, C, 64) from the per-layer cotangents
    (T, K, P) of the winners' α (``ga``) and rgb (``gwr``, ``gwg``,
    ``gwb``), chained through α = op·ρ and rgb = color + y·SH as sweep 2 of
    the JAX backward kernels (``rtgs_tpu/ops/peel.py:786-867``); dOp is
    masked by acceptance (a winner), not by α > 0, so a transparent splat
    can still revive. ``a``, ``b``, ``rho``, ``alpha``: the winners'
    shading (:func:`_shade_layers`).

    A slot's row is summed in the backward kernels' order: pixel group of
    ``PIXEL_GROUP`` (the only one at P ≤ 256), then layer, then pixel, each
    sum a :func:`segment_rows` (row by row on the CPU, the kernel on the
    card)."""
    won = slots >= 0
    ga_alpha = ga * alpha
    d_a = ga_alpha * (-(b * b) / ((4.0 * a) * a))
    d_b = ga_alpha * (b / (2.0 * a))
    d_op = ga * rho
    pix_l = pix[:, None, :, :]                          # (T, 1, P, 24)
    lanes = torch.cat([
        d_a[..., None] * pix_l[..., 3:9],               # 0:6   m6
        2.0 * d_b[..., None] * pix_l[..., 0:3],         # 6:9   Me
        -ga_alpha[..., None],                           # 9     c0
        d_op[..., None],                                # 10    opacity
        gwr[..., None], gwg[..., None], gwb[..., None],  # 11:14 color
        gwr[..., None] * pix_l[..., 9:24],              # 14:29 SH·r
        gwg[..., None] * pix_l[..., 9:24],              # 29:44 SH·g
        gwb[..., None] * pix_l[..., 9:24],              # 44:59 SH·b
        torch.zeros_like(pix_l[..., :5]).expand(*ga.shape, 5),
    ], dim=-1)                                          # (T, K, P, 64)
    t, c = candidates.shape
    k, p = slots.shape[1:]
    flat = (torch.arange(t, device=slots.device)[:, None, None] * c
            + slots.long())
    if p > PIXEL_GROUP:
        px = torch.arange(p, device=slots.device)
        key = (((px // PIXEL_GROUP) * k
                + torch.arange(k, device=slots.device)[:, None]) * p + px)
        order = torch.argsort(key.reshape(-1))
        flat = flat.reshape(t, k * p)[:, order]
        won = won.reshape(t, k * p)[:, order]
        lanes = lanes.reshape(t, k * p, F_DIM)[:, order]
    return segment_rows(lanes[won], flat[won], t * c).reshape(t, c, F_DIM)


def peel_fused_cuda(packed: torch.Tensor, candidates: torch.Tensor,
                    counts: torch.Tensor, pix: torch.Tensor, depth: int,
                    screen_counts: torch.Tensor | None = None):
    """Launch the Hopper fused forward kernel (``csrc/peel_fwd.cu``) on the
    current stream.

    Args:
      packed: (N+1, 64) f32 feature table; row N is the sentinel.
      candidates: (T, C) int32 ids, −1 padded, C a multiple of ``CHUNK``.
      counts: (T,) int32 swept prefix length per tile (:func:`_counts`).
      pix: (T, P, 24) f32 pixel features, P ≤ 1024.
      depth: K, 1..``MAX_DEPTH``.
      screen_counts: as :func:`peel_keys_cuda`'s (the counting
        instantiation of the same sweep).

    Returns (radiance (T, 3, P) f32, transmittance (T, P) f32, slots
    (T, K, P) int32). Every input must be a contiguous CUDA tensor on one
    device; a failed build or launch raises. ``peel_fused_cuda.launches``
    counts the launches.
    """
    t, c = candidates.shape
    p = pix.shape[1]
    specs = [
        ("packed", packed, torch.float32, (packed.shape[0], F_DIM)),
        ("candidates", candidates, torch.int32, (t, c)),
        ("counts", counts, torch.int32, (t,)),
        ("pix", pix, torch.float32, (t, p, G_DIM))]
    if screen_counts is not None:
        specs.append(("screen_counts", screen_counts, torch.int64, (2,)))
    dev = _check_launch("peel_fused_cuda", specs, c, p, depth)
    rad = torch.empty((t, 3, p), dtype=torch.float32, device=dev)
    trans = torch.empty((t, p), dtype=torch.float32, device=dev)
    slots = torch.empty((t, depth, p), dtype=torch.int32, device=dev)
    if t == 0:
        return rad, trans, slots
    _FUSED_FWD(dev, packed.data_ptr(), candidates.data_ptr(),
               counts.data_ptr(), pix.data_ptr(), rad.data_ptr(),
               trans.data_ptr(), slots.data_ptr(),
               None if screen_counts is None else screen_counts.data_ptr(),
               t, c, p, depth)
    peel_fused_cuda.launches += 1
    return rad, trans, slots


peel_fused_cuda.launches = 0


def peel_fused_bwd_cuda(packed: torch.Tensor, candidates: torch.Tensor,
                        counts: torch.Tensor, pix: torch.Tensor,
                        slots: torch.Tensor, grad_rad: torch.Tensor,
                        grad_trans: torch.Tensor, depth: int,
                        table: bool = True):
    """Launch the Hopper fused backward kernel (``csrc/peel_bwd.cu``) on
    the current stream. Inputs as :func:`peel_fused_cuda`, plus the
    forward's ``slots`` (T, K, P) int32 and the cotangents ``grad_rad``
    (T, 3, P) and ``grad_trans`` (T, P), f32.

    Stage 1, the kernel: each swept slot's gradient row summed over its
    tile's pixels (:func:`peel_fused_bwd_torch`'s per-slot rows, in its
    order), one row a pair of :func:`pair_layout`'s buffer. With
    ``table=False`` that is the result: (pair rows (M, 64) f32, their ids
    (M,) int32, −1 for a gap). Otherwise stage 2,
    :func:`segment_rows_cuda`, sums them into the gradient of the feature
    table, (N+1, 64) f32, whose sentinel row N is exactly 0. Both stages
    are free of atomics: bitwise the same result for the same inputs.
    ``peel_fused_bwd_cuda.launches`` counts the kernel's launches
    (``segment_rows_cuda.launches`` the second stage's).
    """
    t, c = candidates.shape
    p = pix.shape[1]
    dev = _check_launch("peel_fused_bwd_cuda", (
        ("packed", packed, torch.float32, (packed.shape[0], F_DIM)),
        ("candidates", candidates, torch.int32, (t, c)),
        ("counts", counts, torch.int32, (t,)),
        ("pix", pix, torch.float32, (t, p, G_DIM)),
        ("slots", slots, torch.int32, (t, depth, p)),
        ("grad_rad", grad_rad, torch.float32, (t, 3, p)),
        ("grad_trans", grad_trans, torch.float32, (t, p))), c, p, depth)
    pair_base, m = pair_layout(counts)
    dslot = torch.empty((m, F_DIM), dtype=torch.float32, device=dev)
    ids = torch.empty(m, dtype=torch.int32, device=dev)
    if t > 0:
        _FUSED_BWD(dev, packed.data_ptr(), candidates.data_ptr(),
                   counts.data_ptr(), pix.data_ptr(), slots.data_ptr(),
                   grad_rad.data_ptr(), grad_trans.data_ptr(),
                   pair_base.data_ptr(), dslot.data_ptr(), ids.data_ptr(),
                   t, c, p, depth)
        peel_fused_bwd_cuda.launches += 1
    if not table:
        return dslot, ids
    return segment_rows_cuda(dslot, ids, packed.shape[0])


peel_fused_bwd_cuda.launches = 0


def _scatter_slot_grads(packed: torch.Tensor, candidates: torch.Tensor,
                        dfeats: torch.Tensor) -> torch.Tensor:
    """The (N+1, 64) table gradient from a plain twin's per-slot gradients
    (T, C, 64): stage 2, :func:`segment_rows` over the candidates' ids in
    (tile, slot) order, the order of the kernels' pair rows; the padding's
    zeros go into the sentinel row."""
    return segment_rows(dfeats.reshape(-1, F_DIM),
                        _safe_ids(packed, candidates).reshape(-1),
                        packed.shape[0])


def _use_kernel(impl: str, packed: torch.Tensor) -> bool:
    if impl not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown peel impl {impl!r}")
    return impl == "cuda" or (impl == "auto" and packed.device.type != "cpu")


class PeelFused(torch.autograd.Function):
    """The fused peel with its hand-written backward: the counterpart of
    the JAX ``peel_pallas`` custom VJP. The forward saves its inputs and
    the winners' slots; the backward returns a gradient for ``packed``
    only, in two stages (per-slot rows, then :func:`segment_rows` by
    splat): through the kernels on CUDA tensors, through the plain twin and
    :func:`segment_rows_torch` on CPU tensors (the sentinel row takes the
    padding's zeros)."""

    @staticmethod
    def forward(ctx, packed, candidates, pix, depth, impl):
        use_kernel = _use_kernel(impl, packed)
        if use_kernel:
            rad, trans, slots = peel_fused_cuda(
                packed, candidates, _counts(candidates), pix, depth)
        else:
            rad, trans, slots = peel_fused_torch(packed, candidates, pix,
                                                 depth)
        ctx.save_for_backward(packed, candidates, pix, slots)
        ctx.depth, ctx.use_kernel = depth, use_kernel
        return rad, trans

    @staticmethod
    def backward(ctx, grad_rad, grad_trans):
        # Autograd materializes an unused output's cotangent as zeros.
        packed, candidates, pix, slots = ctx.saved_tensors
        if ctx.use_kernel:
            dpacked = peel_fused_bwd_cuda(
                packed, candidates, _counts(candidates), pix, slots,
                grad_rad.contiguous(), grad_trans.contiguous(), ctx.depth)
        else:
            dpacked = _scatter_slot_grads(packed, candidates,
                                          peel_fused_bwd_torch(
                                              packed, candidates, pix, slots,
                                              grad_rad, grad_trans))
        return dpacked, None, None, None, None


def peel_fused(packed: torch.Tensor, candidates: torch.Tensor,
               pix: torch.Tensor, depth: int, impl: str = "auto"):
    """Fused tile peel, differentiable in ``packed`` (port of the JAX
    ``peel_pallas``): per pixel, the K nearest hits by (t1, candidate
    slot), shaded and composited front to back.

    Args:
      packed: (N+1, 64) f32 per-Gaussian features (row N = sentinel).
      candidates: (T, C) int32 candidate ids, −1 padded, C a multiple of
        ``CHUNK``; interior −1 gaps are allowed.
      pix: (T, P, 24) f32 per-pixel features.
      depth: composited layers K (≤ ``MAX_DEPTH`` on the card).
      impl: ``"auto"`` (the Hopper kernels for CUDA tensors, the plain
        twins for CPU tensors), ``"cuda"`` or ``"torch"``. On CUDA tensors
        ``auto`` launches the kernels or raises; it never falls back.

    Returns (radiance (T, 3, P), transmittance (T, P)). The backward gives
    ``packed`` a gradient and ``candidates``/``pix`` none, as the JAX rule.

    Determinism: forward and gradient are bitwise repeatable on the card,
    as the JAX package's are, with torch's deterministic mode off. The
    forward has no atomics (winners in float64, bitwise those of the twin);
    the backward is two stages without float atomics: the kernel sums each
    (tile, slot) row over its tile's pixels in a fixed order (pixel group,
    layer, pixel) into a compacted per-pair buffer, and ``segment_rows.cu``
    sums each splat's pair rows in pair order. The plain twin sums in the
    same orders (on the card's tensors it is held to 1e-4 of each lane's
    largest entry; its products come from torch's elementwise kernels).
    """
    return PeelFused.apply(packed, candidates, pix, depth, impl)


# ---------------------------------------------------------------------------
# Top-K peel: select and shade the K nearest, without compositing (port of
# rtgs_tpu.ops.peel.peel_topk_pallas), with a hand-written backward.
# ---------------------------------------------------------------------------

# Lanes of the layer table (T, 5, K, P) the top-K kernel writes.
TOPK_LANES = ("t1", "alpha", "r", "g", "b")


def peel_topk_torch(packed: torch.Tensor, candidates: torch.Tensor,
                    pix: torch.Tensor, depth: int):
    """Plain twin of the top-K forward kernel (the counterpart of the JAX
    ``peel_topk_xla``): select the K nearest by (t1, slot) (as
    :func:`select_slots`) and shade them in f32 (:func:`_shade_layers`),
    without compositing. Differentiable in ``packed`` through the shading.

    Returns (layers (T, 5, K, P) f32 with lanes ``TOPK_LANES``, slots
    (T, K, P) int32). Vacant layers have t1 = +inf and α = r = g = b = 0
    (they shade the sentinel row)."""
    with torch.no_grad():
        t1, slots = _select(packed.detach(), candidates, pix.detach(), depth)
    _, _, _, alpha, rgb = _shade_layers(
        _winner_rows(packed, candidates, slots), pix, slots >= 0)
    return torch.stack([t1, alpha, *rgb], dim=1), slots


def peel_topk_bwd_torch(packed: torch.Tensor, candidates: torch.Tensor,
                        pix: torch.Tensor, slots: torch.Tensor,
                        grad_layers: torch.Tensor) -> torch.Tensor:
    """Plain twin of the top-K backward kernel: per-slot feature gradients
    (T, C, 64) for the winners ``slots``, from the caller's per-layer
    cotangents ``grad_layers`` (T, 4, K, P) of (α, r, g, b), chained by
    :func:`_slot_grads` with no suffix recurrence."""
    a, b, rho, alpha, _ = _shade_layers(
        _winner_rows(packed, candidates, slots), pix, slots >= 0)
    return _slot_grads(candidates, pix, slots, a, b, rho, alpha,
                       *grad_layers.unbind(1))


def peel_topk_cuda(packed: torch.Tensor, candidates: torch.Tensor,
                   counts: torch.Tensor, pix: torch.Tensor, depth: int):
    """Launch the Hopper top-K forward kernel (``csrc/peel_topk_fwd.cu``)
    on the current stream. Inputs as :func:`peel_fused_cuda`.

    Returns (layers (T, 5, K, P) f32 with lanes ``TOPK_LANES``, slots
    (T, K, P) int32). Every input must be a contiguous CUDA tensor on one
    device; a failed build or launch raises. ``peel_topk_cuda.launches``
    counts the launches."""
    t, c = candidates.shape
    p = pix.shape[1]
    dev = _check_launch("peel_topk_cuda", (
        ("packed", packed, torch.float32, (packed.shape[0], F_DIM)),
        ("candidates", candidates, torch.int32, (t, c)),
        ("counts", counts, torch.int32, (t,)),
        ("pix", pix, torch.float32, (t, p, G_DIM))), c, p, depth)
    layers = torch.empty((t, len(TOPK_LANES), depth, p), dtype=torch.float32,
                         device=dev)
    slots = torch.empty((t, depth, p), dtype=torch.int32, device=dev)
    if t == 0:
        return layers, slots
    _TOPK_FWD(dev, packed.data_ptr(), candidates.data_ptr(),
              counts.data_ptr(), pix.data_ptr(), layers.data_ptr(),
              slots.data_ptr(), t, c, p, depth)
    peel_topk_cuda.launches += 1
    return layers, slots


peel_topk_cuda.launches = 0


def peel_topk_bwd_cuda(packed: torch.Tensor, candidates: torch.Tensor,
                       counts: torch.Tensor, pix: torch.Tensor,
                       slots: torch.Tensor, grad_layers: torch.Tensor,
                       depth: int, table: bool = True):
    """Launch the Hopper top-K backward kernel (``csrc/peel_topk_bwd.cu``)
    on the current stream. Inputs as :func:`peel_fused_cuda`, plus the
    forward's ``slots`` (T, K, P) int32 and the per-layer cotangents
    ``grad_layers`` (T, 4, K, P) f32 of (α, r, g, b). Returns, as
    :func:`peel_fused_bwd_cuda` does, the gradient of the feature table
    (N+1, 64) f32 (row N exactly 0; bitwise repeatable), or with
    ``table=False`` the kernel's pair rows and their ids.
    ``peel_topk_bwd_cuda.launches`` counts the kernel's launches."""
    t, c = candidates.shape
    p = pix.shape[1]
    dev = _check_launch("peel_topk_bwd_cuda", (
        ("packed", packed, torch.float32, (packed.shape[0], F_DIM)),
        ("candidates", candidates, torch.int32, (t, c)),
        ("counts", counts, torch.int32, (t,)),
        ("pix", pix, torch.float32, (t, p, G_DIM)),
        ("slots", slots, torch.int32, (t, depth, p)),
        ("grad_layers", grad_layers, torch.float32, (t, 4, depth, p))),
        c, p, depth)
    pair_base, m = pair_layout(counts)
    dslot = torch.empty((m, F_DIM), dtype=torch.float32, device=dev)
    ids = torch.empty(m, dtype=torch.int32, device=dev)
    if t > 0:
        _TOPK_BWD(dev, packed.data_ptr(), candidates.data_ptr(),
                  counts.data_ptr(), pix.data_ptr(), slots.data_ptr(),
                  grad_layers.data_ptr(), pair_base.data_ptr(),
                  dslot.data_ptr(), ids.data_ptr(), t, c, p, depth)
        peel_topk_bwd_cuda.launches += 1
    if not table:
        return dslot, ids
    return segment_rows_cuda(dslot, ids, packed.shape[0])


peel_topk_bwd_cuda.launches = 0


class PeelTopK(torch.autograd.Function):
    """The top-K peel with its hand-written backward: the counterpart of
    the JAX ``peel_topk_pallas`` custom VJP. The forward returns the layer
    table (T, 5, K, P) and saves its inputs and the winners' slots; the
    backward drops the t1 cotangent (the order is piecewise constant, as
    the JAX rule does) and returns a gradient for ``packed`` only, as
    :class:`PeelFused` does."""

    @staticmethod
    def forward(ctx, packed, candidates, pix, depth, impl):
        use_kernel = _use_kernel(impl, packed)
        if use_kernel:
            layers, slots = peel_topk_cuda(packed, candidates,
                                           _counts(candidates), pix, depth)
        else:
            layers, slots = peel_topk_torch(packed, candidates, pix, depth)
        ctx.save_for_backward(packed, candidates, pix, slots)
        ctx.depth, ctx.use_kernel = depth, use_kernel
        return layers

    @staticmethod
    def backward(ctx, grad_layers):
        packed, candidates, pix, slots = ctx.saved_tensors
        grad_layers = grad_layers[:, 1:].contiguous()     # (α, r, g, b)
        if ctx.use_kernel:
            dpacked = peel_topk_bwd_cuda(packed, candidates,
                                         _counts(candidates), pix, slots,
                                         grad_layers, ctx.depth)
        else:
            dpacked = _scatter_slot_grads(packed, candidates,
                                          peel_topk_bwd_torch(
                                              packed, candidates, pix, slots,
                                              grad_layers))
        return dpacked, None, None, None, None


def peel_topk(packed: torch.Tensor, candidates: torch.Tensor,
              pix: torch.Tensor, depth: int, impl: str = "auto"):
    """Tile top-K peel, differentiable in ``packed`` (port of the JAX
    ``peel_topk_pallas``, the per-shard primitive of the primitive-sharded
    ring renderer): per pixel, the K nearest hits by (t1, candidate slot),
    shaded and NOT composited; ``composite_hits`` of
    :mod:`rtgs_tpu_torch.render.oracle` composites the lists.

    Args as :func:`peel_fused`; ``impl``: ``"auto"`` (the Hopper kernels
    for CUDA tensors, the plain twins for CPU tensors), ``"cuda"`` or
    ``"torch"``. On CUDA tensors ``auto`` launches the kernels or raises.

    Returns ``(t1, alpha, r, g, b)``, each (T, P, K), depth-ascending;
    vacant layers have t1 = +inf and α = r = g = b = 0. t1 is the float64
    entry depth rounded once (the JAX package's is f32). The gradient
    flows through α and rgb to ``packed``; t1's cotangent is dropped.
    Determinism as :func:`peel_fused`: forward and gradient are bitwise
    repeatable (the backward's two stages, per-slot rows in a fixed order
    and :func:`segment_rows` by splat, share the fused path's code).
    """
    layers = PeelTopK.apply(packed, candidates, pix, depth, impl)
    return tuple(layers.transpose(2, 3).unbind(1))
