"""rtgs_tpu_torch — the PyTorch/CUDA port of rtgs_tpu, the differentiable
ray-traced Gaussian splat renderer.

Mirrors :mod:`rtgs_tpu`'s module layout; imports torch and numpy, never
JAX. The keys-path kernel is hand-written CUDA for Hopper
(``ops/csrc/keys.cu``), built at first use.

TF32 is switched off here: the ray quadratic cancels, and low-precision
inputs to it have broken renders of the JAX package before.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from rtgs_tpu_torch.gaussians import Gaussians  # noqa: E402
from rtgs_tpu_torch.camera import (Camera, camera_from_fov,  # noqa: E402
                                   new_camera)
from rtgs_tpu_torch.scene import (load_scene, random_scene,  # noqa: E402
                                  save_scene)

__all__ = [
    "Gaussians",
    "Camera",
    "new_camera",
    "camera_from_fov",
    "load_scene",
    "save_scene",
    "random_scene",
]
