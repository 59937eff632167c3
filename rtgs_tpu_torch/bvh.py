"""Linear BVH over Gaussians: build and nearest-hit queries (port of
:mod:`rtgs_tpu.bvh`), as plain torch on the scene's device.

  * **Build**: a Morton-code LBVH (Karras 2012). Centroids are quantized to
    a 30-bit Morton grid and sorted once; each internal node's range and
    split come from vectorized binary searches on common-prefix lengths,
    and the boxes propagate bottom up in a fixed number of parallel passes.
  * **Query**: stackless traversal by escape indices ("ropes"): each node
    stores where to go when its subtree is skipped, so a query is a loop
    with no stack, run here for a whole batch of rays at once.

Camera rays go through the tile pipeline instead (``render/binning.py``);
this serves arbitrary rays, the capability of the reference's ``Scene.hit``.
It is no kernel port: the JAX package runs it as XLA, and nothing on the
render path traverses it.

Morton codes are uint32 in JAX; torch has few uint32 operations, so they
are carried in int64 here (30 bits, exact), and node indices are int64.
The sort is stable, as ``jnp.argsort`` is, so duplicate codes build the
same tree as in JAX.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.rays import Rays


class LBVH(NamedTuple):
    """Linear BVH in leaf-sorted order.

    Internal nodes 0..N-2, leaves N-1..2N-2 (leaf i holds sorted prim i).

    Attributes:
      left, right: (2N-1,) int64 child indices (-1 for leaves).
      pmin, pmax: (2N-1, 3) f32 node boxes.
      escape: (2N-1,) int64 node to jump to when skipping this subtree
        (-1 = done), in depth-first order (left before right).
      prim: (2N-1,) int64 original primitive index of a leaf (-1 internal).
    """

    left: torch.Tensor
    right: torch.Tensor
    pmin: torch.Tensor
    pmax: torch.Tensor
    escape: torch.Tensor
    prim: torch.Tensor


def morton_codes(points: torch.Tensor, lo, hi) -> torch.Tensor:
    """30-bit Morton codes (int64) of points quantized into the [lo, hi]
    box."""
    q = torch.clamp((points - lo) / torch.clamp(hi - lo, min=1e-12),
                    0.0, 1.0)
    cells = torch.clamp((q * 1024.0).to(torch.int64), max=1023)

    def spread(x):  # interleave bits with two zero gaps
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return (spread(cells[:, 0]) << 2 | spread(cells[:, 1]) << 1
            | spread(cells[:, 2]))


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of non-negative values below 2³², as 32-bit words."""
    n = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        mask = x >= (1 << shift)
        n = torch.where(mask, n + shift, n)
        x = torch.where(mask, x >> shift, x)
    return torch.where(x == 0, 32, 31 - n)


def build_lbvh(means, quats, scales, mask=None) -> LBVH:
    """Build the LBVH of a Gaussian set on its device.

    Dead (masked) Gaussians get empty boxes at the far corner, so they sort
    to the end and never intersect."""
    n = means.shape[0]
    dev = means.device
    i64 = torch.int64
    pmin_p, pmax_p = G.aabb(means, quats, scales)
    if mask is not None:
        dead = (mask <= 0)[:, None]
        pmin_p = torch.where(dead, 1e30, pmin_p)
        pmax_p = torch.where(dead, 1e30, pmax_p)
    centroids = 0.5 * (pmin_p + pmax_p)
    finite = torch.isfinite(centroids)
    lo = torch.where(finite, centroids, 1e30).amin(dim=0)
    hi = torch.where(finite, centroids, -1e30).amax(dim=0)
    codes = morton_codes(centroids, lo, hi)

    order = torch.argsort(codes, stable=True)
    codes_s = codes[order]
    leaf0 = n - 1  # leaves occupy [n-1, 2n-2]

    def delta(i, j):
        """Prefix length κ(i, j) on the sorted codes; equal codes are told
        apart by their indices."""
        valid = (j >= 0) & (j < n)
        j_safe = torch.clamp(j, 0, n - 1)
        x = codes_s[i] ^ codes_s[j_safe]
        lz = torch.where(x == 0, 32 + _clz32(i ^ j_safe), _clz32(x))
        return torch.where(valid, lz, -1)

    # Karras 2012: each internal node's range and split.
    i = torch.arange(n - 1, device=dev)
    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    d = torch.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    lmax = torch.full_like(i, 2)     # upper bound of the range by doubling
    for _ in range(32):
        lmax = torch.where(delta(i, i + lmax * d) > delta_min, lmax * 2,
                           lmax)
    length = torch.zeros_like(i)     # binary search of the other end
    t = lmax // 2
    for _ in range(33):
        cond = delta(i, i + (length + t) * d) > delta_min
        length = torch.where((t > 0) & cond, length + t, length)
        t = t // 2
    j = i + length * d

    delta_node = delta(i, j)         # split: binary search of the prefix
    s = torch.zeros_like(i)
    t = -(-length // 2)
    for _ in range(33):
        cond = delta(i, i + (s + t) * d) > delta_node
        s = torch.where((t > 0) & cond, s + t, s)
        t = torch.where(t > 1, -(-t // 2), 0)
    gamma = i + s * d + torch.clamp(d, max=0)

    left = torch.where(torch.minimum(i, j) == gamma, leaf0 + gamma, gamma)
    right = torch.where(torch.maximum(i, j) == gamma + 1,
                        leaf0 + gamma + 1, gamma + 1)
    none = torch.full((n,), -1, dtype=i64, device=dev)
    left_all = torch.cat([left, none])
    right_all = torch.cat([right, none])
    prim_all = torch.cat([none[:n - 1], order])

    # Bottom-up boxes: fixed passes of parallel child unions. The expected
    # depth is O(log n); 2·⌈log2 n⌉ + 8 passes cover practical Morton
    # distributions (the JAX package's count).
    passes = 2 * max(int(math.ceil(math.log2(max(n, 2)))), 1) + 8
    inf = torch.full((n - 1, 3), math.inf, device=dev)
    pmin_all = torch.cat([inf, pmin_p[order]])
    pmax_all = torch.cat([-inf, pmax_p[order]])
    for _ in range(passes):
        pmin_all[:n - 1] = torch.minimum(pmin_all[left], pmin_all[right])
        pmax_all[:n - 1] = torch.maximum(pmax_all[left], pmax_all[right])

    # Escape indices: escape(left(i)) = right(i), escape(right(i)) =
    # escape(i), escape(root) = -1, by fixed-point passes.
    escape = torch.full((2 * n - 1,), -2, dtype=i64, device=dev)
    escape[0] = -1
    for _ in range(passes):
        escape[left] = right
        escape[right] = escape[:n - 1].clone()
        escape[0] = -1

    return LBVH(left=left_all, right=right_all,
                pmin=pmin_all.float(), pmax=pmax_all.float(),
                escape=escape, prim=prim_all)


def _slab_hit(pmin, pmax, origin, inv_dir, t_best):
    """Ray-box slab test over the last axis: whether the box is entered
    before it is left and before ``t_best``."""
    t0 = (pmin - origin) * inv_dir
    t1 = (pmax - origin) * inv_dir
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    return (tmin < tmax) & (tmin < t_best)


class SceneHit(NamedTuple):
    """The reference's ``SceneHit``: the nearest Gaussian's index (-1 =
    miss) and its (t1, t2) interval; ``steps`` is the port's addition, the
    nodes each ray visited (``max_steps`` where the query was cut)."""

    gaussian_idx: torch.Tensor
    t1: torch.Tensor
    t2: torch.Tensor
    steps: torch.Tensor


def bvh_hit(bvh: LBVH, g: G.Gaussians, rays: Rays,
            max_steps: int = 4096) -> SceneHit:
    """Nearest hit of each ray of a flat bundle (P,) by stackless traversal:
    the smallest t1 with ``start < t1 < end`` among live Gaussians, as the
    reference's ``Scene.hit`` accepts. Σ⁻¹ is the adjugate form, as in the
    JAX package.

    The JAX function runs one ``while_loop`` per ray under ``vmap``; here
    one loop steps every active ray at once and a ray stops at the end of
    the rope or after ``max_steps`` nodes. Results are bitwise those of
    stepping each ray alone."""
    cov_inv = G.inv_covariance(g.quats, g.scales)
    origin, direction = rays.origins, rays.directions
    tiny = torch.where(direction < 0, -1e-12, 1e-12)
    inv_dir = 1.0 / torch.where(direction.abs() < 1e-12, tiny, direction)
    p = origin.shape[0]
    dev = origin.device
    node = torch.zeros(p, dtype=torch.int64, device=dev)
    steps = torch.zeros(p, dtype=torch.int64, device=dev)
    best_idx = torch.full((p,), -1, dtype=torch.int64, device=dev)
    best_t1 = torch.full((p,), math.inf, device=dev)
    best_t2 = torch.full((p,), math.inf, device=dev)
    for it in range(max_steps):
        # One host sync every 32 steps: a finished ray's state is frozen,
        # so stepping past the last one changes nothing.
        if it % 32 == 0 and not bool((node >= 0).any()):
            break
        active = node >= 0
        nd = node.clamp(min=0)
        box_ok = _slab_hit(bvh.pmin[nd], bvh.pmax[nd], origin, inv_dir,
                           best_t1)
        prim = bvh.prim[nd]
        is_leaf = prim >= 0
        pidx = prim.clamp(min=0)
        t1, t2 = G.hit(cov_inv[pidx], g.means[pidx], origin, direction)
        accept = (active & box_ok & is_leaf & (t1 > rays.starts)
                  & (t1 < rays.ends) & (t1 < best_t1) & (g.mask[pidx] > 0))
        best_idx = torch.where(accept, pidx, best_idx)
        best_t2 = torch.where(accept, t2, best_t2)
        best_t1 = torch.where(accept, t1, best_t1)
        nxt = torch.where(box_ok & ~is_leaf, bvh.left[nd], bvh.escape[nd])
        node = torch.where(active, nxt, node)
        steps = steps + active.to(torch.int64)
    return SceneHit(best_idx, best_t1, best_t2, steps)
