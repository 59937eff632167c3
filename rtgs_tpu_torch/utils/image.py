"""Image export and import helpers (PNG via imageio or PIL when present,
``.npy`` otherwise); numpy copy of :mod:`rtgs_tpu.utils.image`."""

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


def load_image(path) -> np.ndarray:
    """Load an image as float32 (H, W, 3) in [0, 1]: ``.npy`` with numpy,
    anything else with imageio or, failing that, PIL (one of them must be
    installed for PNGs)."""
    path = pathlib.Path(path)
    if path.suffix == ".npy":
        arr = np.load(path)
    else:
        try:
            import imageio.v3 as iio

            arr = iio.imread(path)
        except ImportError:
            from PIL import Image

            arr = np.asarray(Image.open(path))
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr[..., :3].astype(np.float32)
