"""Renderer dispatch (port of :mod:`rtgs_tpu.render.api`).

  * ``oracle`` — brute force O(N·P), the reference's semantics
    (:func:`~rtgs_tpu_torch.render.oracle.render_oracle`); differentiable
    through torch autograd.
  * ``tiled`` — the per-tile argmin peel
    (:func:`~rtgs_tpu_torch.render.tiled.render_tiled`); differentiable
    through torch autograd.
  * ``pallas`` — the fused-payload path
    (:func:`~rtgs_tpu_torch.render.tiled.render_tiled_pallas`), with a
    hand-written backward (what training uses by default).
  * ``keys`` — the keys path
    (:func:`~rtgs_tpu_torch.render.tiled.render_tiled_keys`).
  * ``auto`` — the keys path, on every device and scene size. (The JAX
    ``auto`` renders scenes of at most 4096 splats through the oracle, and
    larger ones through ``pallas`` on its chip and ``tiled`` elsewhere.)

The tiled-only knobs (candidate budgets, banding, binning) mean nothing to
the oracle, and ``render_tiled`` has no banding: they are dropped rather
than refused, so one set of CLI flags drives every renderer.
"""

from __future__ import annotations

import torch

from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.camera import Camera

_TILED_ONLY = ("max_candidates", "max_global", "tile_bands",
               "max_tiles_local", "tile", "bin_narrow")


def render(g: G.Gaussians, camera: Camera, depth: int = 16,
           renderer: str = "auto", **kwargs) -> torch.Tensor:
    """Render a full frame. Returns (W, H, 3) radiance."""
    if renderer in ("auto", "keys"):
        from rtgs_tpu_torch.render.tiled import render_tiled_keys

        return render_tiled_keys(g, camera, depth=depth, **kwargs)
    if renderer == "pallas":
        from rtgs_tpu_torch.render.tiled import render_tiled_pallas

        return render_tiled_pallas(g, camera, depth=depth, **kwargs)
    if renderer == "oracle":
        from rtgs_tpu_torch.render.oracle import render_oracle

        kwargs = {k: v for k, v in kwargs.items() if k not in _TILED_ONLY}
        return render_oracle(g, camera, depth=depth, **kwargs)
    if renderer == "tiled":
        from rtgs_tpu_torch.render.tiled import render_tiled

        kwargs.pop("tile_bands", None)
        return render_tiled(g, camera, depth=depth, **kwargs)
    raise ValueError(f"unknown renderer {renderer!r}")


def render_progressive(g: G.Gaussians, camera: Camera, depth: int = 16,
                       samples: int = 1, renderer: str = "auto",
                       jitter: bool = False,
                       generator: torch.Generator | None = None,
                       **kwargs) -> torch.Tensor:
    """Average ``samples`` renders. Without ``jitter`` every sample is the
    same pixel-center render, so this renders once; with it, samples after
    the first take a uniform subpixel offset in [−0.5, 0.5)² drawn from
    ``generator`` (a CPU ``torch.Generator``; seed 0 when omitted), and the
    binning pads projected boxes by the 0.5 px jitter radius."""
    if samples <= 1 or not jitter:
        return render(g, camera, depth=depth, renderer=renderer, **kwargs)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    accum = None
    for s in range(samples):
        off = None if s == 0 else tuple(
            (torch.rand(2, generator=generator, dtype=torch.float64)
             - 0.5).tolist())
        img = render(g, camera, depth=depth, renderer=renderer,
                     pixel_offset=off, **kwargs)
        accum = img if accum is None else accum + img
    return accum / samples
