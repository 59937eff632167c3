"""Brute-force O(N·rays) oracle renderer (port of
:mod:`rtgs_tpu.render.oracle`): the reference's semantics as one batched,
differentiable torch program, and the port's ground truth.

* :func:`composite_rays` / :func:`render_oracle` — intersect all
  Gaussians, keep the K nearest entry points, and composite front to back
  with an exclusive cumulative product for transmittance. Differentiable
  end to end through the gather of the K nearest.
* :func:`render_peeled_reference` — the reference's iterative peel (argmin
  per step, ``start = t1 + 1e-8``), used in tests to show that both agree.

Compositing contract:
  * a hit is accepted iff ``t1 ∈ (start, end)``, an open interval;
  * the response is evaluated at the chord midpoint ``(t1 + t2)/2``;
  * ``sample += T · α · rgb; T *= 1 − α``;
  * exactly ``depth`` layers are composited, with no early stop.

Ties in t1 go to the lower splat index, as ``lax.top_k`` breaks them in the
JAX package: the selection is a stable sort of t1 with +inf for invalid
entries (``torch.topk`` promises no order among ties).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.camera import Camera, generate_ray_grid
from rtgs_tpu_torch.rays import Rays

# The reference's peel advance epsilon.
PEEL_EPS = 1e-8


def _safe_midpoint_alpha(gathered_cov_inv, gathered_means, gathered_opac,
                         origins, directions, t1, t2, valid):
    """The response at the chord midpoint, α = op·exp(−dᵀΣ⁻¹d), with the
    midpoint set to 0 on invalid or infinite entries so no inf reaches the
    arithmetic (nor its gradient). ``origins``/``directions`` broadcast
    against ``t1``'s shape plus a trailing (3,)."""
    tbar = 0.5 * (t1 + t2)
    ok = valid & torch.isfinite(tbar)
    tbar_safe = torch.where(ok, tbar, 0.0)
    d = origins + tbar_safe[..., None] * directions - gathered_means
    rho = torch.exp(-torch.sum(d * G._matvec(gathered_cov_inv, d), dim=-1))
    # Δ == 0 gives t2 = inf → ρ = exp(−inf) = 0 in the reference.
    return torch.where(ok, gathered_opac * rho, 0.0)


def topk_hits(g: G.Gaussians, rays: Rays, k: int):
    """The K nearest accepted hits of each ray of a flat bundle (P,),
    ascending by entry depth t1.

    Returns ``(t1 (P, K), alpha (P, K), rgb (P, K, 3))``; misses are padded
    with ``t1 = inf``, ``alpha = 0``, ``rgb = 0``."""
    cov_inv = G.inv_covariance(g.quats, g.scales)          # (N, 3, 3)
    t1, t2 = G.hit(cov_inv, g.means, rays.origins[..., None, :],
                   rays.directions[..., None, :])          # (P, N)
    valid = ((t1 > rays.starts[..., None]) & (t1 < rays.ends[..., None])
             & (g.mask > 0))
    kk = min(k, g.num)
    with torch.no_grad():
        key = torch.where(valid, t1, math.inf)
        idx = torch.sort(key, dim=-1, stable=True).indices[..., :kk]
    valid_k = valid.gather(-1, idx)
    t1_k = torch.where(valid_k, t1.gather(-1, idx), math.inf)
    t2_k = t2.gather(-1, idx)

    alpha = _safe_midpoint_alpha(
        cov_inv[idx], g.means[idx], g.opacities[idx],
        rays.origins[..., None, :], rays.directions[..., None, :],
        t1_k, t2_k, valid_k)
    dirs = rays.directions / torch.linalg.norm(rays.directions, dim=-1,
                                               keepdim=True)
    rgb = g.colors[idx] + G.eval_sh(g.sh[idx], dirs[..., None, :])
    rgb = torch.where(valid_k[..., None], rgb, 0.0)

    if kk < k:  # scene smaller than K: pad the lists
        pad = k - kk
        t1_k = F.pad(t1_k, (0, pad), value=math.inf)
        alpha = F.pad(alpha, (0, pad))
        rgb = F.pad(rgb, (0, 0, 0, pad))
    return t1_k, alpha, rgb


def composite_hits(t1, alpha, rgb):
    """Front-to-back compositing of depth-ascending hit lists, with the
    exclusive-cumprod transmittance ``T_k = Π_{j<k} (1 − α_j)``. ``t1`` is
    unused: the lists are already ordered and ``alpha = 0`` marks misses.

    Returns (radiance (..., 3), transmittance (...,))."""
    del t1
    one_minus = 1.0 - alpha
    trans = torch.cat([torch.ones_like(alpha[..., :1]),
                       torch.cumprod(one_minus[..., :-1], dim=-1)], dim=-1)
    radiance = torch.sum((trans * alpha)[..., None] * rgb, dim=-2)
    return radiance, torch.prod(one_minus, dim=-1)


def composite_rays(g: G.Gaussians, rays: Rays, depth: int = 16):
    """Render a flat bundle of rays (P,) against all Gaussians, brute
    force. Returns (radiance (P, 3), transmittance (P,)) after ``depth``
    layers."""
    return composite_hits(*topk_hits(g, rays, depth))


def render_oracle(g: G.Gaussians, camera: Camera, depth: int = 16,
                  pixel_chunk: int | None = None,
                  pixel_offset=None) -> torch.Tensor:
    """Full-frame brute-force render. Returns (W, H, 3) radiance.

    The rays run in chunks of ``pixel_chunk`` (default: the (chunk, N)
    intersection bounded to 2²⁵ elements), one after the other."""
    w, h = camera.buf_size
    rays = generate_ray_grid(camera, pixel_offset).reshape(w * h)
    p = w * h
    if pixel_chunk is None:
        pixel_chunk = max(64, min(p, (1 << 25) // max(g.num, 1)))
    radiance = torch.cat([
        composite_rays(g, Rays(*(x[s:s + pixel_chunk] for x in rays)),
                       depth=depth)[0]
        for s in range(0, p, pixel_chunk)])
    return radiance.reshape(w, h, 3)


def render_peeled_reference(g: G.Gaussians, rays: Rays, depth: int = 16):
    """The reference's per-launch depth peel, brute force: per step, the
    nearest unconsumed Gaussian of each ray (argmin of t1 over N; ties to
    the lower index), composited, then ``start = t1 + 1e-8`` (a miss sets
    ``start = inf``). O(depth · N · P); for tests.

    Returns (radiance (P, 3), transmittance (P,))."""
    cov_inv = G.inv_covariance(g.quats, g.scales)
    live = g.mask > 0
    dirs_n = rays.directions / torch.linalg.norm(rays.directions, dim=-1,
                                                 keepdim=True)
    t1, t2 = G.hit(cov_inv, g.means, rays.origins[..., None, :],
                   rays.directions[..., None, :])
    starts = rays.starts
    radiance = torch.zeros(starts.shape + (3,), device=starts.device)
    trans = torch.ones(starts.shape, device=starts.device)
    for _ in range(depth):
        valid = (t1 > starts[..., None]) & (t1 < rays.ends[..., None]) & live
        t1m = torch.where(valid, t1, math.inf)
        idx = torch.argmin(t1m, dim=-1)                            # (P,)
        hit_any = t1m.gather(-1, idx[..., None])[..., 0] < math.inf
        t1_h = t1.gather(-1, idx[..., None])[..., 0]
        t2_h = t2.gather(-1, idx[..., None])[..., 0]
        alpha = _safe_midpoint_alpha(
            cov_inv[idx], g.means[idx], g.opacities[idx],
            rays.origins, rays.directions, t1_h, t2_h, hit_any)
        rgb = g.colors[idx] + G.eval_sh(g.sh[idx], dirs_n)
        radiance = radiance + (trans * alpha)[..., None] * rgb
        trans = trans * (1.0 - alpha)
        starts = torch.where(hit_any, t1_h + PEEL_EPS, math.inf)
    return radiance, trans
