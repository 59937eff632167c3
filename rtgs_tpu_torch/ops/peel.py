"""Keys-only tile top-K: per pixel, the K nearest ``(t1, splat id)`` among
its tile's candidates (port of the keys half of :mod:`rtgs_tpu.ops.peel`).

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

Two implementations with one contract: :func:`peel_keys_cuda`, the
hand-written Hopper kernel (``csrc/keys.cu``), and :func:`peel_keys_torch`,
its plain twin. Both evaluate t1 with the same operations in the same
order, and the kernel is built without FMA contraction, so on the card
the two agree bitwise. :func:`peel_keys` picks by the tensors' device.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

F_DIM = 64
G_DIM = 24
# Candidate-chunk width of the kernel's sweep; the binning's chunk_lb must
# be built at this width.
CHUNK = 128
# The kernel keeps each pixel's list in registers, instantiated for these
# capacities (csrc/keys.cu).
MAX_DEPTH = 64
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


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"peel_keys_cuda: {msg}")


def peel_keys_cuda(packed: torch.Tensor, candidates: torch.Tensor,
                   counts: torch.Tensor, chunk_lb: torch.Tensor,
                   pix: torch.Tensor, depth: int):
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

    Returns (t1 (T, K, P) f32, sid (T, K, P) int32). Every input must be a
    contiguous CUDA tensor on one device; a failed build or launch raises.
    ``peel_keys_cuda.launches`` counts the launches.
    """
    dev = packed.device
    _require(dev.type == "cuda", f"needs CUDA tensors, got {dev}")
    t, c = candidates.shape
    p = pix.shape[1]
    for name, x, dtype, shape in (
            ("packed", packed, torch.float32, (packed.shape[0], F_DIM)),
            ("candidates", candidates, torch.int32, (t, c)),
            ("counts", counts, torch.int32, (t,)),
            ("chunk_lb", chunk_lb, torch.float32, (t, c // CHUNK + 1)),
            ("pix", pix, torch.float32, (t, p, G_DIM))):
        _require(x.device == dev, f"{name} is on {x.device}, not {dev}")
        _require(x.dtype == dtype, f"{name} is {x.dtype}, want {dtype}")
        _require(tuple(x.shape) == shape,
                 f"{name} has shape {tuple(x.shape)}, want {shape}")
        _require(x.is_contiguous(), f"{name} is not contiguous")
    _require(c % CHUNK == 0, f"candidate width {c} is not a multiple of "
             f"{CHUNK}")
    _require(1 <= depth <= MAX_DEPTH, f"depth {depth} outside 1..{MAX_DEPTH}")
    _require(1 <= p <= 1024, f"{p} pixels per tile; one block holds ≤ 1024")

    t1 = torch.empty((t, depth, p), dtype=torch.float32, device=dev)
    sid = torch.empty((t, depth, p), dtype=torch.int32, device=dev)
    if t == 0:
        return t1, sid
    from rtgs_tpu_torch.ops import _build

    lib = _build.load_library()
    ptr = ctypes.c_void_p
    err = lib.rtgs_keys_sid(
        ptr(packed.data_ptr()), ptr(candidates.data_ptr()),
        ptr(counts.data_ptr()), ptr(chunk_lb.data_ptr()),
        ptr(pix.data_ptr()), ptr(t1.data_ptr()), ptr(sid.data_ptr()),
        t, c, p, depth, dev.index if dev.index is not None
        else torch.cuda.current_device(),
        ptr(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError("keys kernel launch failed: "
                           f"{lib.rtgs_cuda_error_string(err).decode()}")
    peel_keys_cuda.launches += 1
    return t1, sid


peel_keys_cuda.launches = 0


def peel_keys(packed: torch.Tensor, candidates: torch.Tensor,
              pix: torch.Tensor, depth: int, impl: str = "auto",
              chunk_lb: torch.Tensor | None = None):
    """Keys-only top-K dispatcher. Index selection has no gradient, so the
    inputs are detached.

    ``impl``: ``"auto"`` (the kernel for CUDA tensors, the twin for CPU
    tensors), ``"cuda"`` or ``"torch"``. ``chunk_lb`` enables the kernel's
    exact early exit; the twin sorts everything and ignores it. Returns
    (t1, sid), each (T, K, P)."""
    packed, pix = packed.detach(), pix.detach()
    if impl not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown keys impl {impl!r}")
    if impl == "torch" or (impl == "auto" and packed.device.type == "cpu"):
        return peel_keys_torch(packed, candidates, pix, depth)
    t, c = candidates.shape
    if chunk_lb is None:
        chunk_lb = torch.zeros((t, c // CHUNK + 1), device=packed.device)
    return peel_keys_cuda(packed, candidates, _counts(candidates),
                          chunk_lb.detach(), pix, depth)
