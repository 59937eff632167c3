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
  * ``auto`` — the JAX package's rule (:func:`resolve_renderer`): the
    oracle for scenes of at most ``_ORACLE_MAX_N`` (4096) splats; larger
    ones through ``pallas`` when the scene lies on a CUDA device (the
    fused kernel, ``ops/csrc/peel_fwd.cu``) and through ``tiled``
    elsewhere. Training resolves ``auto`` by the same rule.

The tiled-only knobs (candidate budgets, banding, binning) mean nothing to
the oracle, and ``render_tiled`` has no banding: they are dropped rather
than refused, so one set of CLI flags drives every renderer.
"""

from __future__ import annotations

import torch

from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.camera import Camera
from rtgs_tpu_torch.utils.profiling import span

_TILED_ONLY = ("max_candidates", "max_global", "tile_bands",
               "max_tiles_local", "tile", "bin_narrow")
# Below this many Gaussians brute force is both exact and faster than
# binning overhead (the JAX package's threshold, under its name).
_ORACLE_MAX_N = 4096
RENDERERS = ("oracle", "tiled", "pallas", "keys")


def resolve_renderer(renderer: str, num: int, device) -> str:
    """The renderer that ``renderer`` names for a scene of ``num`` splats
    on ``device`` (the scene's own device, never what the machine has):
    ``auto`` is ``oracle`` at ``num <= _ORACLE_MAX_N``, else ``pallas`` on
    a CUDA device and ``tiled`` elsewhere, as the JAX ``render`` resolves
    it on its chip and off it; the names in ``RENDERERS`` stand for
    themselves; anything else raises ``ValueError``."""
    if renderer == "auto":
        if num <= _ORACLE_MAX_N:
            return "oracle"
        return "pallas" if torch.device(device).type == "cuda" else "tiled"
    if renderer in RENDERERS:
        return renderer
    raise ValueError(f"unknown renderer {renderer!r}")


def render(g: G.Gaussians, camera: Camera, depth: int = 16,
           renderer: str = "auto", **kwargs) -> torch.Tensor:
    """Render a full frame. Returns (W, H, 3) radiance. Under a profiler
    the frame is one ``render`` span, the top of its layers' spans."""
    with span("render", g.device):
        renderer = resolve_renderer(renderer, g.num, g.device)
        if renderer == "keys":
            from rtgs_tpu_torch.render.tiled import render_tiled_keys

            return render_tiled_keys(g, camera, depth=depth, **kwargs)
        if renderer == "pallas":
            from rtgs_tpu_torch.render.tiled import render_tiled_pallas

            return render_tiled_pallas(g, camera, depth=depth, **kwargs)
        if renderer == "oracle":
            from rtgs_tpu_torch.render.oracle import render_oracle

            kwargs = {k: v for k, v in kwargs.items() if k not in _TILED_ONLY}
            return render_oracle(g, camera, depth=depth, **kwargs)
        from rtgs_tpu_torch.render.tiled import render_tiled   # "tiled"

        kwargs.pop("tile_bands", None)
        return render_tiled(g, camera, depth=depth, **kwargs)


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
        off = None if s == 0 else _jitter(generator)
        img = render(g, camera, depth=depth, renderer=renderer,
                     pixel_offset=off, **kwargs)
        accum = img if accum is None else accum + img
    return accum / samples


def _jitter(generator: torch.Generator):
    """One uniform subpixel offset (ox, oy) in [−0.5, 0.5)²."""
    return tuple((torch.rand(2, generator=generator, dtype=torch.float64)
                  - 0.5).tolist())


class ProgressiveSampler:
    """Stateful sample accumulator (port of
    :class:`rtgs_tpu.render.api.ProgressiveSampler`): ``sample()`` adds one
    full render to the buffer, ``clear()`` resets it (on camera motion),
    ``display()`` divides by the sample count.

    One sample composites all ``depth`` layers at once, so the reference's
    fractional display denominator (partial peel passes) collapses to the
    whole sample count, as in the JAX package. With ``jitter``, samples
    after the first take an offset drawn from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when omitted) in the order
    :func:`render_progressive` draws them, so N samples display what
    ``render_progressive(samples=N, jitter=True)`` returns with a generator
    of the same seed. ``clear()`` does not rewind the generator."""

    def __init__(self, g: G.Gaussians, camera: Camera, depth: int = 16,
                 renderer: str = "auto", jitter: bool = False,
                 generator: torch.Generator | None = None, **kwargs):
        self._g, self._camera = g, camera
        self._depth, self._renderer = depth, renderer
        self._jitter, self._kwargs = jitter, kwargs
        self._generator = (generator if generator is not None
                           else torch.Generator().manual_seed(0))
        self.clear()

    def clear(self):
        self._buf = None
        self.num_samples = 0

    def sample(self):
        off = (None if self.num_samples == 0 or not self._jitter
               else _jitter(self._generator))
        img = render(self._g, self._camera, depth=self._depth,
                     renderer=self._renderer, pixel_offset=off,
                     **self._kwargs)
        self._buf = img if self._buf is None else self._buf + img
        self.num_samples += 1
        return self

    def display(self) -> torch.Tensor:
        if self._buf is None:
            raise RuntimeError("no samples accumulated; call sample() first")
        return self._buf / self.num_samples
