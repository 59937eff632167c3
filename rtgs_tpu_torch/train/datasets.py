"""Multiview datasets for the training loop (port of
:mod:`rtgs_tpu.train.datasets`):

  * :func:`synthetic_orbit_dataset` — ground-truth renders of a scene from
    an orbit of poses (self-supervised fit targets);
  * :func:`load_transforms_dataset` — a ``transforms.json`` loader
    (nerfstudio / Blender-NeRF convention: OpenGL camera-to-world matrices,
    which match this renderer's −z-forward/+y-up camera).

Images are float32 numpy arrays (W, H, 3) in the render layout; cameras
live on the requested device.
"""

from __future__ import annotations

import json
import math
import pathlib
from typing import List, NamedTuple

import numpy as np
import torch

from rtgs_tpu_torch.camera import Camera, camera_from_fov, new_camera
from rtgs_tpu_torch.utils import quaternion as quat


class MultiviewDataset(NamedTuple):
    cameras: List[Camera]
    images: List[np.ndarray]  # each (W, H, 3) float32 in the render layout

    def __len__(self):
        return len(self.cameras)


def synthetic_orbit_dataset(g, num_views: int, res, fov: float = 60.0,
                            radius: float = 3.0, phi: float = 1.2,
                            depth: int = 16, renderer: str = "auto",
                            **render_kwargs) -> MultiviewDataset:
    """Render ground-truth views of ``g`` from an orbit of poses, under
    ``torch.inference_mode()``, on the scene's device. ``render_kwargs``
    forward to the renderer (e.g. ``max_candidates``: large scenes need the
    same overflow-free budgets as the fit loop)."""
    from rtgs_tpu_torch.render.api import render
    from rtgs_tpu_torch.viewer.orbit import orbit_camera_pose

    cams, imgs = [], []
    for i in range(num_views):
        theta = 2 * math.pi * i / num_views
        pos, rot, _, _ = orbit_camera_pose(
            theta, phi, radius, np.zeros(3),
            np.array([0.0, 0.0, 0.0, 1.0]))
        cam = camera_from_fov(pos, rot, res, fov, device=g.device)
        cams.append(cam)
        with torch.inference_mode():
            img = render(g, cam, depth=depth, renderer=renderer,
                         **render_kwargs)
        imgs.append(img.cpu().numpy())
    return MultiviewDataset(cams, imgs)


def _display_to_render_layout(img_hw3: np.ndarray) -> np.ndarray:
    """(H, W, 3) top-row-first image → the renderer's (W, H) bottom-left
    buffer layout (inverse of ``camera.image_to_display``)."""
    return np.transpose(img_hw3[::-1], (1, 0, 2)).astype(np.float32)


def load_transforms_dataset(path, downscale: int = 1,
                            device="cpu") -> MultiviewDataset:
    """Load a nerfstudio/Blender ``transforms.json`` dataset. The matrices
    are OpenGL camera-to-world (camera −z forward, +y up), the convention
    of :mod:`rtgs_tpu_torch.camera`, so rotations come straight from the
    3×3 block."""
    from rtgs_tpu_torch.utils.image import load_image

    path = pathlib.Path(path)
    meta = json.loads(path.read_text())
    root = path.parent

    cams, imgs = [], []
    for frame in meta["frames"]:
        img_path = root / frame["file_path"]
        if not img_path.suffix:
            img_path = img_path.with_suffix(".png")
        img = load_image(img_path)
        if downscale > 1:
            img = img[::downscale, ::downscale]
        h, w = img.shape[:2]

        m = np.asarray(frame["transform_matrix"], dtype=np.float64)
        rot = quat.from_rotation_matrix(m[:3, :3])
        pos = m[:3, 3]

        if "fl_y" in meta:
            fy = float(meta["fl_y"]) / downscale
            fx = float(meta.get("fl_x", meta["fl_y"])) / downscale
        elif "camera_angle_y" in meta:
            fy = (h / 2) / math.tan(float(meta["camera_angle_y"]) / 2)
            fx = fy
        elif "camera_angle_x" in meta:
            fx = (w / 2) / math.tan(float(meta["camera_angle_x"]) / 2)
            fy = fx
        else:
            raise ValueError("transforms.json missing focal information")

        cams.append(new_camera(pos, rot, (w, h), (fx, fy), device))
        imgs.append(_display_to_render_layout(img))
    return MultiviewDataset(cams, imgs)
