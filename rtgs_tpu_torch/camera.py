"""Pinhole camera (port of :mod:`rtgs_tpu.camera`).

Conventions: the camera looks down −z, +y up, +x right; screen uv ∈ (0,1)²
with (0,0) at the bottom-left; rays pass through pixel centers
``(i+0.5)/W``; the focal length is in pixels, from the vertical FOV as
``focal = (H/2) / tan(fov·π/360)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from rtgs_tpu_torch.rays import Rays
from rtgs_tpu_torch.utils import quaternion as quat
from rtgs_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class Camera:
    """Pinhole camera.

    Attributes:
      position:     (3,) camera position.
      rotation:     (4,) scalar-last quaternion, camera→world.
      focal_length: (2,) focal length in pixels (fx, fy).
      buf_size:     (W, H) render buffer size in pixels.
    """

    position: torch.Tensor
    rotation: torch.Tensor
    focal_length: torch.Tensor
    buf_size: Tuple[int, int]

    @property
    def device(self) -> torch.device:
        return self.position.device


def new_camera(position, rotation, buf_size, focal_length,
               device="cuda") -> Camera:
    """A camera on ``device``, the card unless the caller asks for the
    CPU."""
    device = resolve_device(device)

    def f32(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.float32)
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return Camera(position=f32(position), rotation=f32(rotation),
                  focal_length=f32(focal_length),
                  buf_size=(int(buf_size[0]), int(buf_size[1])))


def camera_from_fov(position, rotation, buf_size, fov_deg: float,
                    device="cuda") -> Camera:
    """Camera from a vertical FOV in degrees:
    ``focal = (H/2)/tan(fov·π/360)`` on both axes; on ``device``, the card
    unless asked."""
    focal = (buf_size[1] / 2.0) / math.tan(fov_deg * math.pi / 360.0)
    return new_camera(position, rotation, buf_size, (focal, focal), device)


def generate_ray(camera: Camera, uv: torch.Tensor) -> Rays:
    """Rays through screen coordinates ``uv`` ∈ (0,1)², shape (..., 2)."""
    censor = torch.tensor(camera.buf_size, dtype=torch.float32,
                          device=uv.device)
    pxy = (censor * uv - 0.5 * censor) / camera.focal_length
    d_cam = torch.cat([pxy, -torch.ones_like(pxy[..., :1])], dim=-1)
    d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    d_world = quat.rot_vec3(camera.rotation, d_cam)
    shape = d_world.shape[:-1]
    return Rays(origins=camera.position.expand(d_world.shape),
                directions=d_world,
                starts=torch.zeros(shape, device=uv.device),
                ends=torch.full(shape, math.inf, device=uv.device))


def generate_ray_grid(camera: Camera, pixel_offset=None) -> Rays:
    """Per-pixel camera rays for the whole buffer, shaped (W, H): index 0
    is the x pixel (left→right), index 1 the y pixel (bottom→top), sampled
    at pixel centers. ``pixel_offset``: optional (ox, oy) subpixel offset
    in pixels (the progressive-sampling jitter)."""
    w, h = camera.buf_size
    ox, oy = (0.0, 0.0) if pixel_offset is None else pixel_offset
    dev = camera.device
    i = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5 + ox) / w
    j = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5 + oy) / h
    uv = torch.stack(torch.meshgrid(i, j, indexing="ij"), dim=-1)  # (W, H, 2)
    return generate_ray(camera, uv)


def image_to_display(img_wh3: torch.Tensor) -> torch.Tensor:
    """The internal (W, H, 3) bottom-left-origin buffer as a conventional
    (H, W, 3) top-row-first image."""
    return img_wh3.permute(1, 0, 2).flip(0)
