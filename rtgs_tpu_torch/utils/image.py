"""Image export helpers (PNG via imageio or PIL when present, ``.npy``
otherwise); numpy copy of :mod:`rtgs_tpu.utils.image`."""

from __future__ import annotations

import pathlib

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Clamp float radiance to [0, 1] and quantize."""
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255 + 0.5).astype(np.uint8)


def save_image(path, img: np.ndarray) -> None:
    """Save an (H, W, 3) float image: PNG if imageio or PIL is available,
    otherwise ``.npy`` beside the requested path."""
    path = pathlib.Path(path)
    arr = to_uint8(img)
    try:
        import imageio.v3 as iio

        iio.imwrite(path, arr)
        return
    except Exception:
        pass
    try:
        from PIL import Image

        Image.fromarray(arr).save(path)
        return
    except Exception:
        np.save(path.with_suffix(".npy"), arr)
