"""Ray bundles as a structure of arrays (port of :mod:`rtgs_tpu.rays`)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rtgs_tpu_torch.utils.device import resolve_device


class Rays(NamedTuple):
    """A bundle of rays.

    Attributes:
      origins:    (..., 3) ray origins.
      directions: (..., 3) ray directions (unit length for camera rays).
      starts:     (...,)   minimum accepted ``t`` (exclusive).
      ends:       (...,)   maximum accepted ``t`` (exclusive; ``inf`` for
                  camera rays).
    """

    origins: torch.Tensor
    directions: torch.Tensor
    starts: torch.Tensor
    ends: torch.Tensor

    def get(self, t: torch.Tensor) -> torch.Tensor:
        """Position along the ray: ``origin + t · direction``."""
        return self.origins + t[..., None] * self.directions

    def reshape(self, *shape) -> "Rays":
        return Rays(self.origins.reshape(*shape, 3),
                    self.directions.reshape(*shape, 3),
                    self.starts.reshape(*shape),
                    self.ends.reshape(*shape))


def new_rays(origins, directions, starts=None, ends=None,
             device="cuda") -> Rays:
    """Constructor with the reference's defaults: ``start = 0``,
    ``end = inf``; on ``device``, the card unless the caller asks for the
    CPU."""
    device = resolve_device(device)

    def f32(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.float32)
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    origins, directions = f32(origins), f32(directions)
    shape = origins.shape[:-1]
    starts = (torch.zeros(shape, device=origins.device) if starts is None
              else f32(starts).expand(shape).clone())
    ends = (torch.full(shape, math.inf, device=origins.device)
            if ends is None else f32(ends).expand(shape).clone())
    return Rays(origins, directions, starts, ends)
