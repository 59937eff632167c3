"""Renderer dispatch (port of :mod:`rtgs_tpu.render.api`).

``auto`` and ``keys`` render through
:func:`~rtgs_tpu_torch.render.tiled.render_tiled_keys`, the keys path, on
every device and scene size. ``pallas`` renders through
:func:`~rtgs_tpu_torch.render.tiled.render_tiled_pallas`, the
fused-payload path with a hand-written backward (what training uses).
``oracle`` and ``tiled`` are not ported yet and raise.
"""

from __future__ import annotations

import torch

from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.camera import Camera

_NOT_PORTED = {
    "oracle": "ROADMAP queue 1, item 3 (oracle)",
    "tiled": "ROADMAP queue 1, item 10 (secondary renderers)",
}


def render(g: G.Gaussians, camera: Camera, depth: int = 16,
           renderer: str = "auto", **kwargs) -> torch.Tensor:
    """Render a full frame. Returns (W, H, 3) radiance."""
    if renderer in ("auto", "keys"):
        from rtgs_tpu_torch.render.tiled import render_tiled_keys

        return render_tiled_keys(g, camera, depth=depth, **kwargs)
    if renderer == "pallas":
        from rtgs_tpu_torch.render.tiled import render_tiled_pallas

        return render_tiled_pallas(g, camera, depth=depth, **kwargs)
    if renderer in _NOT_PORTED:
        raise NotImplementedError(
            f"renderer {renderer!r} is not ported yet; see "
            f"{_NOT_PORTED[renderer]}")
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
