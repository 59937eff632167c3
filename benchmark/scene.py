"""Seeded inputs of the benchmark: the synthetic scene and the orbit poses.

The scene follows ``random_scene``'s law (the port's
``rtgs_tpu_torch/scene.py:random_scene_arrays``, the JAX package's
``random_scene``): means uniform in a cube of half-size ``extent``, random
unit quaternions (normalised standard normals), per-axis scales
log-uniform in ``scale_range``, base colors uniform in ``color_range``,
opacities uniform in ``opacity_range`` and SH coefficients of degrees 1-3
normal with standard deviation ``sh_std``. Unlike the port's copy it draws
on the run's device from a ``torch.Generator`` seeded with ``--seed``, in
one call a field, so a 1M scene costs milliseconds of set-up. Both the
program and the reference receive these tensors.
"""

from __future__ import annotations

import math

import torch

NUM_SH = 15   # SH coefficients of degrees 1..3 a channel


def generator(seed: int, device, salt: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` (any integer, wider
    than 32 bits too) and a ``salt`` that keeps the draws of different
    inputs apart."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + salt) % (2**63 - 1))


def uniform_scene(cfg: dict, seed: int, device) -> dict:
    """The scene of configuration ``cfg`` (its ``scene`` entry) drawn from
    ``seed`` on ``device``: float32 ``means`` (N, 3), ``quats`` (N, 4)
    scalar-last, ``scales`` (N, 3), ``colors`` (N, 3), ``opacities`` (N,)
    and ``sh`` (N, 15, 3)."""
    s = cfg["scene"]
    n, ext = int(s["n"]), float(s["extent"])
    gen = generator(seed, device, salt=1)
    f32 = dict(dtype=torch.float32, device=device, generator=gen)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, **f32)

    quats = torch.randn((n, 4), **f32)
    lo, hi = s["scale_range"]
    return dict(
        means=uniform((n, 3), -ext, ext),
        quats=quats / torch.linalg.norm(quats, dim=-1, keepdim=True),
        scales=torch.exp(uniform((n, 3), math.log(lo), math.log(hi))),
        colors=uniform((n, 3), *s["color_range"]),
        opacities=uniform((n,), *s["opacity_range"]),
        sh=s["sh_std"] * torch.randn((n, NUM_SH, 3), **f32),
    )


def orbit_theta0(seed: int) -> float:
    """The turntable's first angle θ₀ in [0, 2π), drawn from ``seed``."""
    gen = generator(seed, "cpu", salt=2)
    return 2.0 * math.pi * float(torch.rand((), generator=gen,
                                            dtype=torch.float64))


def orbit_pose(theta: float, phi: float, r: float):
    """The orbit camera at (θ, φ, r) looking at the origin, z up: position
    (3,) and the camera's axes (right, up, back) as the columns of a 3×3
    rotation, float64 (the camera looks down its −z axis, the viewer's
    convention)."""
    pos = torch.tensor([r * math.cos(theta) * math.sin(phi),
                        r * math.sin(theta) * math.sin(phi),
                        r * math.cos(phi)], dtype=torch.float64)
    look = -pos / torch.linalg.norm(pos)
    right = torch.tensor([-math.sin(theta), math.cos(theta), 0.0],
                         dtype=torch.float64)
    up = torch.linalg.cross(right, look)
    return pos, torch.stack([right, up, -look], dim=1)
