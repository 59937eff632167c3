"""Every public constructor of the port puts its tensors on the card unless
the caller asks for the CPU, as the JAX package puts its arrays on its
default device: without CUDA, a call that names no device raises, and none
builds CPU tensors unasked. With ``device="cpu"`` each builds CPU tensors."""

import json

import numpy as np
import pytest
import torch

from rtgs_tpu_torch import bridge, camera, gaussians, rays, scene
from rtgs_tpu_torch.train import datasets
from rtgs_tpu_torch.utils.device import resolve_device
from rtgs_tpu_torch.utils.image import save_image

_POS, _ROT = [0.0, 0.0, 3.0], [0.0, 0.0, 0.0, 1.0]
_O, _D = [[0.0, 0.0, 3.0]], [[0.0, 0.0, -1.0]]


def _ply(tmp):
    path = tmp / "scene.ply"
    scene.save_scene(path, scene.random_scene(8, seed=1, device="cpu"))
    return path


def _transforms(tmp):
    save_image(tmp / "v0.png", np.full((8, 6, 3), 0.5, np.float32))
    (tmp / "transforms.json").write_text(json.dumps({
        "camera_angle_x": 0.8,
        "frames": [{"file_path": "v0",
                    "transform_matrix": np.eye(4).tolist()}]}))
    return tmp / "transforms.json"


_FIELDS = dict(means=np.zeros((2, 3), np.float32),
               quats=np.tile(np.float32([0, 0, 0, 1]), (2, 1)),
               scales=np.ones((2, 3), np.float32),
               colors=np.ones((2, 3), np.float32),
               opacities=np.ones(2, np.float32),
               sh=np.zeros((2, 15, 3), np.float32),
               mask=np.ones(2, np.float32))
_CAMERA = dict(position=np.float32(_POS), rotation=np.float32(_ROT),
               focal_length=np.float32([10.0, 10.0]), buf_size=(4, 3))
_RAYS = dict(origins=np.float32(_O), directions=np.float32(_D),
             starts=np.zeros(1, np.float32), ends=np.ones(1, np.float32))
_PARAMS = dict(means=np.zeros((2, 3)), log_scales=np.zeros((2, 3)),
               quats=np.tile([0.0, 0.0, 0.0, 1.0], (2, 1)),
               color_logits=np.zeros((2, 3)), opacity_logits=np.zeros(2),
               sh=np.zeros((2, 15, 3)))

# name → (a call that names no device, a function of its result that lists
# the tensors it built), for the twelve public constructors.
CONSTRUCTORS = {
    "scene.load_scene": (lambda tmp, **kw: scene.load_scene(_ply(tmp), **kw),
                         lambda g: [g.means, g.sh]),
    "scene.random_scene": (lambda tmp, **kw: scene.random_scene(4, **kw),
                           lambda g: [g.means, g.mask]),
    "scene.anisotropic_scene": (
        lambda tmp, **kw: scene.anisotropic_scene(4, **kw),
        lambda g: [g.scales]),
    "gaussians.new_gaussians": (
        lambda tmp, **kw: gaussians.new_gaussians([[0.0, 0.0, 0.0]], **kw),
        lambda g: [g.means, g.colors, g.mask]),
    "camera.new_camera": (
        lambda tmp, **kw: camera.new_camera(_POS, _ROT, (4, 3), (10.0, 10.0),
                                            **kw),
        lambda c: [c.position, c.rotation, c.focal_length]),
    "camera.camera_from_fov": (
        lambda tmp, **kw: camera.camera_from_fov(_POS, _ROT, (4, 3), 60.0,
                                                 **kw),
        lambda c: [c.position, c.focal_length]),
    "rays.new_rays": (lambda tmp, **kw: rays.new_rays(_O, _D, **kw),
                      lambda r: list(r)),
    "datasets.load_transforms_dataset": (
        lambda tmp, **kw: datasets.load_transforms_dataset(_transforms(tmp),
                                                           **kw),
        lambda d: [d.cameras[0].position]),
    "bridge.gaussians_from_numpy": (
        lambda tmp, **kw: bridge.gaussians_from_numpy(_FIELDS, **kw),
        lambda g: [g.means, g.mask]),
    "bridge.camera_from_numpy": (
        lambda tmp, **kw: bridge.camera_from_numpy(_CAMERA, **kw),
        lambda c: [c.position]),
    "bridge.rays_from_numpy": (
        lambda tmp, **kw: bridge.rays_from_numpy(_RAYS, **kw),
        lambda r: list(r)),
    "bridge.params_from_numpy": (
        lambda tmp, **kw: bridge.params_from_numpy(_PARAMS, **kw),
        lambda p: list(p)),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructor_defaults_to_the_card(name, tmp_path):
    build, tensors = CONSTRUCTORS[name]
    for x in tensors(build(tmp_path, device="cpu")):
        assert x.device.type == "cpu"
    if torch.cuda.is_available():
        for x in tensors(build(tmp_path)):
            assert x.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build(tmp_path)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
