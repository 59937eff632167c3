"""Numpy bridge between the JAX package's objects and the port's.

Inputs are read field by field with ``np.asarray``, so a JAX ``Gaussians``
or ``Camera``, a plain namespace or a mapping of arrays all work, and this
module never imports JAX. The tests use it to feed one scene and one camera
to both packages.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.camera import Camera, new_camera


def _field(src, name):
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def gaussians_from_numpy(src, device="cpu") -> G.Gaussians:
    """A port :class:`~rtgs_tpu_torch.gaussians.Gaussians` from any object
    or mapping holding the seven scene fields."""
    return G.Gaussians(**{
        f: torch.from_numpy(np.array(_field(src, f), np.float32)).to(device)
        for f in G.FIELDS})


def gaussians_to_numpy(g: G.Gaussians) -> Dict[str, np.ndarray]:
    """The seven scene fields as float32 numpy arrays."""
    return {f: getattr(g, f).detach().cpu().numpy() for f in G.FIELDS}


def camera_from_numpy(src, device="cpu") -> Camera:
    """A port :class:`~rtgs_tpu_torch.camera.Camera` from any object or
    mapping with ``position``, ``rotation``, ``focal_length`` and
    ``buf_size``."""
    return new_camera(np.asarray(_field(src, "position")),
                      np.asarray(_field(src, "rotation")),
                      tuple(_field(src, "buf_size")),
                      np.asarray(_field(src, "focal_length")), device)


def camera_to_numpy(cam: Camera) -> dict:
    return {
        "position": cam.position.detach().cpu().numpy(),
        "rotation": cam.rotation.detach().cpu().numpy(),
        "focal_length": cam.focal_length.detach().cpu().numpy(),
        "buf_size": tuple(cam.buf_size),
    }
