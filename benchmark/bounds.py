"""The least time the card could take for a launch of the port's kernels:
the table of peaks and the operations and bytes of each kernel, from the
launch's own inputs and outputs.

A frozen copy of ``chip_smoke.py``'s ``bound``, ``peel_bound`` and
``segment_bound`` (with ``SWEEP_F64`` and ``SHADE_F32``), with two changes:
K is each launch's own depth (a pass of a deep peel selects at most 64
layers), not a constant; and a sweep counts only the work an exact K-nearest
result needs. The original charged the float64 entry-depth chain to every
(pixel, live candidate) pair, but a sweep need not run it on pairs its f32
screen rejects, nor look at all past the chunks whose entry-depth lower
bound lies beyond the pixel's K-th hit (the keys kernel's exact early
exit): a kernel that skips that work read above 100%. Here a sweep costs the
f32 screen (``SCREEN_F32``) on each needed pair and the float64 chain on
each winner. The shares count the work the inputs need, so they read the
same whatever implements the kernel.

Each ``*_launch`` function takes a wrapped call's arguments, keyword
arguments and result and a ``side`` helper (``side(fn, *xs)``: ``fn(*xs)``,
a 0-d tensor, computed off the timed stream) and returns the launch's
shape; :func:`launch_ms` turns a shape into milliseconds.
"""

from __future__ import annotations

# Peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W): device
# memory 3.35 TB/s, float32 67 TFLOP/s and float64 34 TFLOP/s outside the
# tensor cores (the kernels use none).
HBM_BPS, F32_OPS, F64_OPS = 3.35e12, 67e12, 34e12
# Operations per unit of work, counted from the sources. Per (pixel, needed
# candidate) the f32 screen of Δ/4 = b² − A·c0: A 11, b 5, Δ 3. Per winner
# the float64 entry-depth chain: A 11, B 6, Δ 4; and, f32:
# quad 28 (A, B, Δ, the exponent, exp, α), three colors 30 each, composite
# 9; the backwards re-shade and add ~60 products and 59 sums per winner
# (and the fused one ~30 for its recurrences).
SWEEP_F64 = 21
SCREEN_F32 = 19
SHADE_F32 = dict(peel_fwd=127, peel_topk_fwd=118, peel_bwd=280,
                 peel_topk_bwd=250)


def bound(nbytes, f32_ops=0.0, f64_ops=0.0) -> float:
    """Milliseconds: the bytes over the memory rate against the operations
    over the peak of their type, whichever is longer."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = (f32_ops / F32_OPS + f64_ops / F64_OPS) * 1e3
    return max(t_bytes, t_ops)


def peel_bound(kind: str, shape: dict) -> float:
    """Bound of a peel kernel from one launch: ``shape`` holds T, C, P, K,
    the table's rows n, the live (tile, candidate) pairs, the winners
    (non-vacant layers) and, for the sweeps, the needed (pixel, candidate)
    pairs (:func:`needed_pairs`; where the launch has no chunk bounds, every
    live pair against each pixel). Inputs once: the live ids,
    each referenced row once (40 bytes for the keys kernel, which reads
    lanes 0-9; 236 for the others), the pixel lanes the kernel reads (9 for
    the keys kernel; all 24 for the others, which also shade), counts and
    bounds. Outputs once, and of the backwards' gradient one row a live
    pair."""
    t, c, p, k = shape["t"], shape["c"], shape["p"], shape["k"]
    live = shape["live"]
    rows = min(live, shape["n"])
    common = live * 4 + t * 4
    layers = t * k * p * 4
    if kind in ("keys_sid", "peel_fwd", "peel_topk_fwd"):
        screen = shape.get("needed", live * p) * SCREEN_F32
        chain = shape["winners"] * SWEEP_F64
    if kind == "keys_sid":
        return bound(common + t * p * 9 * 4 + rows * 40
                     + t * (c // 128 + 1) * 4 + 2 * layers, screen, chain)
    common += t * p * 24 * 4 + rows * 236
    shade = shape["winners"] * SHADE_F32[kind]
    if kind == "peel_fwd":
        return bound(common + t * p * 16 + layers, shade + screen, chain)
    if kind == "peel_topk_fwd":
        return bound(common + 6 * layers, shade + screen, chain)
    grads = t * p * 16 if kind == "peel_bwd" else 4 * layers
    return bound(common + layers + grads + live * 64 * 4, shade)


def segment_bound(m: int, n: int) -> float:
    """segment_rows.cu: M rows of 64 f32 and their ids read once, n rows
    written once, against one f32 add a lane and input row."""
    return bound((m + n) * 64 * 4 + 4 * m, f32_ops=64 * m)


def _count(x):
    """Entries of ``x`` that are ≥ 0."""
    return (x >= 0).sum()


def needed_pairs(cand, chunk_lb, t1_last):
    """The (pixel, live candidate) pairs an exact K-nearest sweep with chunk
    bounds has to look at (without them: every live candidate of a tile
    against each of its pixels). ``chunk_lb`` (T, C/chunk + 1) holds the
    least entry depth of the candidates from chunk j on; a pixel needs the live
    candidates of the chunks whose bound is at or below its K-th hit's entry
    depth (``t1_last`` (T, P), +inf where it has fewer than K hits), and may
    skip the rest."""
    t, c = cand.shape
    nch = chunk_lb.shape[1] - 1
    live = (cand >= 0).reshape(t, nch, c // nch).sum(-1)        # (T, nch)
    need = chunk_lb[:, :nch, None] <= t1_last[:, None, :]       # (T, nch, P)
    return (need.sum(-1) * live).sum()


def peel_fwd_launch(args, kwargs, out, side) -> dict:
    """``peel_fused_cuda(packed, candidates, counts, pix, depth, ...)`` →
    (radiance, transmittance, slots). It has no chunk bounds: every live
    pair is needed."""
    packed, cand, _counts, pix, depth = args[:5]
    live = side(_count, cand)
    return dict(kind="peel_fwd", t=cand.shape[0], c=cand.shape[1],
                p=pix.shape[1], k=depth, n=packed.shape[0], live=live,
                winners=side(_count, out[2]))


def peel_bwd_launch(args, kwargs, out, side) -> dict:
    """``peel_fused_bwd_cuda(packed, candidates, counts, pix, slots,
    grad_rad, grad_trans, depth, ...)``."""
    packed, cand, _counts, pix, slots = args[:5]
    return dict(kind="peel_bwd", t=cand.shape[0], c=cand.shape[1],
                p=pix.shape[1], k=args[7], n=packed.shape[0],
                live=side(_count, cand), winners=side(_count, slots))


def keys_launch(args, kwargs, out, side) -> dict:
    """``peel_keys_cuda(packed, candidates, counts, chunk_lb, pix, depth,
    ...)`` → (t1, sid): the needed pairs from the chunk bounds and each
    pixel's K-th t1."""
    packed, cand, _counts, lb, pix, depth = args[:6]
    t1, sid = out
    return dict(kind="keys_sid", t=cand.shape[0], c=cand.shape[1],
                p=pix.shape[1], k=depth, n=packed.shape[0],
                live=side(_count, cand), winners=side(_count, sid),
                needed=side(needed_pairs, cand, lb, t1[:, -1]))


def segment_launch(args, kwargs, out, side) -> dict:
    """``segment_rows_cuda(rows, ids, n_out)``."""
    return dict(kind="segment", m=args[0].shape[0], n=args[2])


def launch_ms(shape: dict) -> float:
    """The bound of a launch's shape, its counts resolved to integers."""
    if shape["kind"] == "segment":
        return segment_bound(shape["m"], shape["n"])
    return peel_bound(shape["kind"], shape)
