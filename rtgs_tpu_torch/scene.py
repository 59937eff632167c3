"""Gaussian-splat scene: load/save with the activation contract, and a
seeded synthetic scene (port of :mod:`rtgs_tpu.scene`).

Activations on load: scalar-first ``rot_0..3`` → scalar-last
``(rot_1, rot_2, rot_3, rot_0)`` and normalize; ``scale = exp(scale_raw) ·
global_scale``; ``color = sigmoid(f_dc)`` (no SH degree-0 constant);
``opacity = sigmoid(opacity_raw)``; ``f_rest_0..44`` → 15 RGB SH triples in
the ``"inria"`` (channel-major on disk) or ``"reference_flat"`` layout.
"""

from __future__ import annotations

import logging
import pathlib
from typing import Dict

import numpy as np
import torch

from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.io.ply import read_ply, write_ply
from rtgs_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def sigmoid(x: np.ndarray) -> np.ndarray:
    """Numerically stable sigmoid, in float64."""
    out = np.empty_like(x, dtype=np.float64)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


def inverse_sigmoid(y: np.ndarray) -> np.ndarray:
    return np.log(y) - np.log1p(-y)


def _from_numpy(device, **fields) -> G.Gaussians:
    n = fields["means"].shape[0]
    fields.setdefault("mask", np.ones((n,), np.float32))
    return G.Gaussians(**{
        k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
        for k, v in fields.items()})


def load_scene(path, scale: float = 1.0, sh_layout: str = "inria",
               device="cuda") -> G.Gaussians:
    """Load a ``.ply`` (62-property 3DGS schema) or ``.splt``/``.splat``
    scene onto ``device`` (the card unless the caller asks for the CPU;
    :func:`~rtgs_tpu_torch.utils.device.resolve_device`).

    ``sh_layout``: ``"inria"`` (correct channel pairing) or
    ``"reference_flat"`` (the reference's (N, 3, 15) buffer read as
    (N, 15, 3))."""
    device = resolve_device(device)
    path = pathlib.Path(path)
    if path.suffix.lower() in (".splt", ".splat"):
        from rtgs_tpu_torch.io.splt import read_splt

        d = read_splt(path)
        logger.info("splt cloud loaded from %s with %d points.", path,
                    d["means"].shape[0])
        d["scales"] = d["scales"] * scale
        return _from_numpy(device, **d)
    cols = read_ply(path)
    n = len(cols["x"])
    logger.info("Point cloud loaded from %s with %d points.", path, n)

    means = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
    quats = np.stack(
        [cols["rot_1"], cols["rot_2"], cols["rot_3"], cols["rot_0"]], axis=1)
    quats = quats / np.linalg.norm(quats, axis=-1, keepdims=True)
    scales = np.exp(
        np.stack([cols["scale_0"], cols["scale_1"], cols["scale_2"]], axis=1)
    ) * scale
    colors = sigmoid(
        np.stack([cols["f_dc_0"], cols["f_dc_1"], cols["f_dc_2"]], axis=1))
    opacities = sigmoid(cols["opacity"].astype(np.float64))
    frest = np.stack(
        [cols[f"f_rest_{i}"] for i in range(3 * G.NUM_SH_COEFFS)], axis=1)
    if sh_layout == "inria":
        sh = frest.reshape(n, 3, G.NUM_SH_COEFFS).transpose(0, 2, 1)
    elif sh_layout == "reference_flat":
        sh = frest.reshape(n, G.NUM_SH_COEFFS, 3)
    else:
        raise ValueError(f"unknown sh_layout: {sh_layout!r}")
    return _from_numpy(device, means=means, quats=quats, scales=scales,
                       colors=colors, opacities=opacities, sh=sh)


def save_scene(path, g: G.Gaussians, scale: float = 1.0,
               sh_layout: str = "inria") -> None:
    """Write the live Gaussians to the 62-property ``.ply`` schema with
    inverse activations (or ``.splt``/``.splat``, SH dropped)."""
    def host(x, dtype=np.float32):
        return x.detach().cpu().numpy().astype(dtype)[live]

    live = g.mask.detach().cpu().numpy() > 0
    path = pathlib.Path(path)
    if path.suffix.lower() in (".splt", ".splat"):
        from rtgs_tpu_torch.io.splt import write_splt

        write_splt(path, host(g.means), host(g.quats), host(g.scales) / scale,
                   host(g.colors), host(g.opacities))
        return
    means, quats, scales, sh = (host(g.means), host(g.quats), host(g.scales),
                                host(g.sh))
    colors = np.clip(host(g.colors, np.float64), 1e-7, 1 - 1e-7)
    opac = np.clip(host(g.opacities, np.float64), 1e-7, 1 - 1e-7)
    n = means.shape[0]

    cols: Dict[str, np.ndarray] = {}
    for i, k in enumerate("xyz"):
        cols[k] = means[:, i]
    for k in ("nx", "ny", "nz"):
        cols[k] = np.zeros(n, np.float32)
    for i in range(3):
        cols[f"f_dc_{i}"] = inverse_sigmoid(colors[:, i]).astype(np.float32)
    if sh_layout == "inria":
        frest = sh.transpose(0, 2, 1).reshape(n, 45)
    else:
        frest = sh.reshape(n, 45)
    for i in range(45):
        cols[f"f_rest_{i}"] = frest[:, i]
    cols["opacity"] = inverse_sigmoid(opac).astype(np.float32)
    for i in range(3):
        cols[f"scale_{i}"] = np.log(
            np.maximum(scales[:, i] / scale, 1e-30)).astype(np.float32)
    cols["rot_0"] = quats[:, 3]
    for i in range(3):
        cols[f"rot_{i + 1}"] = quats[:, i]
    write_ply(path, cols)


def pad_scene(g: G.Gaussians, multiple: int) -> G.Gaussians:
    """Pad N up to a multiple of ``multiple`` (for sharding) with dead
    Gaussians: ``mask = 0``, unit scale, quaternion w = 1, zero opacity,
    everything else 0. Every hit test and the binning skip them."""
    n = g.num
    pad = -(-n // multiple) * multiple - n
    if pad == 0:
        return g

    def pad_arr(x, fill=0.0):
        return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])

    quats = pad_arr(g.quats)
    quats[n:, 3] = 1.0   # in place on the fresh tensor
    return G.Gaussians(
        means=pad_arr(g.means),
        quats=quats,
        scales=pad_arr(g.scales, fill=1.0),
        colors=pad_arr(g.colors),
        opacities=pad_arr(g.opacities),
        sh=pad_arr(g.sh),
        mask=pad_arr(g.mask),
    )


def random_scene_arrays(n: int, extent: float = 1.0,
                        scale_range=(0.02, 0.1),
                        seed: int = 0) -> Dict[str, np.ndarray]:
    """The fields of :func:`random_scene` as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-extent, extent, (n, 3))
    quats = rng.standard_normal((n, 4))
    quats = quats / np.linalg.norm(quats, axis=-1, keepdims=True)
    lo, hi = scale_range
    fields = dict(
        means=means,
        quats=quats,
        scales=np.exp(rng.uniform(np.log(lo), np.log(hi), (n, 3))),
        colors=rng.uniform(0.05, 0.95, (n, 3)),
        opacities=rng.uniform(0.2, 0.95, (n,)),
        sh=0.05 * rng.standard_normal((n, G.NUM_SH_COEFFS, 3)),
        mask=np.ones((n,)),
    )
    return {k: v.astype(np.float32) for k, v in fields.items()}


def random_scene(n: int, extent: float = 1.0, scale_range=(0.02, 0.1),
                 seed: int = 0, device="cuda") -> G.Gaussians:
    """Seeded synthetic scene: random anisotropic Gaussians in a cube of
    half-size ``extent``, drawn from the same distributions as
    :func:`rtgs_tpu.scene.random_scene` with a numpy ``Generator`` (so the
    bits differ from JAX's), on ``device`` (the card unless asked)."""
    device = resolve_device(device)
    return _from_numpy(device, **random_scene_arrays(n, extent, scale_range,
                                                     seed))


def anisotropic_scene(n: int, extent: float = 0.5,
                      minor_range=(1e-4, 1e-3), ratio_range=(100.0, 1000.0),
                      seed: int = 0, device="cuda") -> G.Gaussians:
    """Seeded scene of needles and discs: as :func:`random_scene`, but every
    splat has one axis drawn log-uniformly from ``minor_range`` and each of
    the other two either equal to it or ``ratio_range`` times longer (at
    least one is), so the scale ratio within a splat is at least
    ``ratio_range[0]``. Seen from very near and from very far it strains the
    entry depth's cancellation and the keys kernel's f32 screen. On
    ``device``, the card unless asked."""
    device = resolve_device(device)
    fields = random_scene_arrays(n, extent, (1.0, 1.0), seed)
    rng = np.random.default_rng(seed + 1)
    minor = np.exp(rng.uniform(np.log(minor_range[0]),
                               np.log(minor_range[1]), (n, 1)))
    ratio = np.exp(rng.uniform(np.log(ratio_range[0]),
                               np.log(ratio_range[1]), (n, 3)))
    long_axis = rng.uniform(size=(n, 3)) < 0.5
    long_axis[np.arange(n), rng.integers(0, 3, n)] = True     # at least one
    long_axis[np.arange(n), rng.integers(0, 3, n)] = False    # the minor one
    stretched = np.where(long_axis, ratio, 1.0)
    none = ~long_axis.any(axis=1)
    stretched[none, 0] = ratio[none, 0]
    fields["scales"] = (minor * stretched).astype(np.float32)
    return _from_numpy(device, **fields)
