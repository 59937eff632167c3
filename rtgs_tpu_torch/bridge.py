"""Numpy bridge between the JAX package's objects and the port's.

Inputs are read field by field with ``np.asarray``, so a JAX ``Gaussians``,
``Camera``, ``Rays`` or ``SceneParams``, a plain namespace or a mapping of
arrays all work, and this module never imports JAX. The tests use it to
feed one scene, one camera, one ray bundle, one parameter set and one Adam
state to both packages. Each ``*_from_numpy`` builds its tensors on
``device``, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.camera import Camera, new_camera
from rtgs_tpu_torch.rays import Rays
from rtgs_tpu_torch.utils.device import resolve_device


def _field(src, name):
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def gaussians_from_numpy(src, device="cuda") -> G.Gaussians:
    """A port :class:`~rtgs_tpu_torch.gaussians.Gaussians` from any object
    or mapping holding the seven scene fields."""
    device = resolve_device(device)
    return G.Gaussians(**{
        f: torch.from_numpy(np.array(_field(src, f), np.float32)).to(device)
        for f in G.FIELDS})


def gaussians_to_numpy(g: G.Gaussians) -> Dict[str, np.ndarray]:
    """The seven scene fields as float32 numpy arrays."""
    return {f: getattr(g, f).detach().cpu().numpy() for f in G.FIELDS}


def camera_from_numpy(src, device="cuda") -> Camera:
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


def rays_from_numpy(src, device="cuda"):
    """A port :class:`~rtgs_tpu_torch.rays.Rays` from any object or mapping
    with ``origins``, ``directions``, ``starts`` and ``ends``."""
    device = resolve_device(device)
    return Rays(*(
        torch.from_numpy(np.array(_field(src, f), np.float32)).to(device)
        for f in Rays._fields))


def rays_to_numpy(rays) -> Dict[str, np.ndarray]:
    """The four ray fields as float32 numpy arrays."""
    return {f: x.detach().cpu().numpy() for f, x in
            zip(rays._fields, rays)}


def params_from_numpy(src, device="cuda"):
    """A port :class:`~rtgs_tpu_torch.train.solver.SceneParams` from any
    object or mapping holding the six raw parameter fields."""
    device = resolve_device(device)
    from rtgs_tpu_torch.train.solver import SceneParams

    return SceneParams(*(
        torch.from_numpy(np.array(_field(src, f), np.float32)).to(device)
        for f in SceneParams._fields))


def params_to_numpy(params) -> Dict[str, np.ndarray]:
    """The six raw parameter fields as float32 numpy arrays (copies: a
    CPU tensor's ``numpy()`` shares its memory)."""
    return {f: x.detach().cpu().numpy().copy() for f, x in
            zip(params._fields, params)}


def adam_state_from_optax(opt_state, optimizer, params) -> None:
    """Carry an optax ``multi_transform`` Adam state (one ``scale_by_adam``
    per parameter group, as the JAX ``make_optimizer`` builds it) into the
    port's per-group ``torch.optim.Adam``: ``mu``, ``nu`` and ``count`` of
    group ``name`` become ``exp_avg``, ``exp_avg_sq`` and ``step`` of the
    parameter of that name. A count of 0 leaves the group's state empty,
    which is how torch starts a fresh Adam."""
    for name, p in zip(params._fields, params):
        adam = opt_state.inner_states[name].inner_state[0]
        count = int(np.asarray(adam.count))
        optimizer.state.pop(p, None)
        if count == 0:
            continue
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.from_numpy(np.array(
                _field(adam.mu, name), np.float32)).to(p.device),
            "exp_avg_sq": torch.from_numpy(np.array(
                _field(adam.nu, name), np.float32)).to(p.device),
        }


def adam_state_to_numpy(optimizer, params) -> Dict[str, dict]:
    """Per parameter group: ``count``, ``mu`` and ``nu`` (zeros for a
    group with no state yet), in optax's names, as numpy copies."""
    out = {}
    for name, p in zip(params._fields, params):
        st = optimizer.state.get(p) or {}
        zeros = np.zeros(tuple(p.shape), np.float32)
        out[name] = {
            "count": int(st["step"]) if "step" in st else 0,
            "mu": (st["exp_avg"].detach().cpu().numpy().copy()
                   if "exp_avg" in st else zeros),
            "nu": (st["exp_avg_sq"].detach().cpu().numpy().copy()
                   if "exp_avg_sq" in st else zeros),
        }
    return out
