"""``.splt`` / ``.splat`` scene I/O (numpy copy of :mod:`rtgs_tpu.io.splt`,
which cannot be imported without JAX).

The de-facto community format (antimatter15 ``.splat``): 32 bytes per
splat, little-endian —

    3 × f32   position
    3 × f32   scale              (post-activation, linear)
    4 × u8    color RGBA         (post-sigmoid, 0-255; A = opacity)
    4 × u8    rotation quat      (scalar-FIRST, (c-128)/128 per component)

SH coefficients do not exist in this format: loading yields degree-0 scenes
(``sh = 0``), saving drops SH (lossy, like every other tool that writes it).
"""

from __future__ import annotations

import numpy as np

RECORD = 32


def read_splt(path):
    """Read a ``.splt``/``.splat`` file → dict of activated arrays."""
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size % RECORD:
        raise ValueError(
            f"{path}: size {raw.size} is not a multiple of {RECORD}")
    n = raw.size // RECORD
    rec = raw.reshape(n, RECORD)
    f32 = rec[:, :24].copy().view("<f4").reshape(n, 6)
    means = f32[:, 0:3].astype(np.float64)
    scales = f32[:, 3:6].astype(np.float64)
    rgba = rec[:, 24:28].astype(np.float64) / 255.0
    # Quat bytes: ((q * 128) + 128) per component, scalar-first.
    q = (rec[:, 28:32].astype(np.float64) - 128.0) / 128.0
    quats = np.stack([q[:, 1], q[:, 2], q[:, 3], q[:, 0]], axis=1)  # → xyzw
    norm = np.linalg.norm(quats, axis=1, keepdims=True)
    quats = quats / np.where(norm > 0, norm, 1.0)
    return dict(
        means=means,
        scales=scales,
        colors=rgba[:, 0:3],
        opacities=rgba[:, 3],
        quats=quats,
        sh=np.zeros((n, 15, 3)),
    )


def write_splt(path, means, quats, scales, colors, opacities):
    """Write activated arrays as ``.splt``/``.splat`` (SH dropped)."""
    n = means.shape[0]
    rec = np.zeros((n, RECORD), np.uint8)
    f32 = np.concatenate(
        [np.asarray(means, np.float32), np.asarray(scales, np.float32)],
        axis=1).astype("<f4")
    rec[:, :24] = f32.view(np.uint8).reshape(n, 24)
    rgba = np.concatenate(
        [np.asarray(colors), np.asarray(opacities)[:, None]], axis=1)
    rec[:, 24:28] = np.clip(np.round(rgba * 255.0), 0, 255).astype(np.uint8)
    q = np.asarray(quats, np.float64)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    q_sf = np.stack([q[:, 3], q[:, 0], q[:, 1], q[:, 2]], axis=1)  # → wxyz
    rec[:, 28:32] = np.clip(
        np.round(q_sf * 128.0 + 128.0), 0, 255).astype(np.uint8)
    rec.tofile(path)
