"""The features kernels (rtgs_tpu_torch/ops/csrc/features.cu) against the
plain chains, on the card. Imports no JAX, so it runs where only the port is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_features_cuda.py

Both evaluate every lane with the same f32 operations in the same order
(each an explicitly rounded intrinsic in the kernels), so the (N+1, 64)
table, its c0 and the (T, P, 24) pixel table must be bitwise the plain
chains' on the same CUDA tensors: at the benchmark scene's law on four
orbit poses at 1920x1088, on unnormalised quaternions, scales at the law's
ends, splats behind the camera, unaligned inputs and row counts around a
block; the pixel table at 1920x1088 in 16x16 tiles, at a ragged 500x300 in
8x8 tiles and with a sub-pixel offset. So a frame renders the same bits
with autograd recording (the table on the chain) as without (both kernels),
and a profiled frame counts one kernel table, a training step none."""

import math

import numpy as np
import pytest
import torch

from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.camera import camera_from_fov
from rtgs_tpu_torch.render import tiled as T
from rtgs_tpu_torch.scene import random_scene
from rtgs_tpu_torch.utils import profiling
from rtgs_tpu_torch.viewer.orbit import orbit_camera_pose

LAW = dict(extent=2.0, scale_range=(0.005, 0.03))   # uniform1m_1080p's


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _camera(theta, res, device, phi=1.2, r=5.0):
    pos, rot, _, _ = orbit_camera_pose(theta, phi, r, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    return camera_from_fov(pos, rot, res, 60.0, device=device)


def _equal(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.equal(got, want), (what, int((got != want).sum()))


def _same_table(g, cam):
    """The kernel's table and c0 bitwise the plain chain's, and the
    dispatcher's fields (views of the table) its fields."""
    before = T.feature_table_cuda.launches
    packed, c0 = T.feature_table_cuda(g, cam)
    ref = T.precompute_features_torch(g, cam)
    want = T.pack_features(ref)
    torch.cuda.synchronize()
    assert T.feature_table_cuda.launches == before + 1
    _equal(packed, want, "table")
    _equal(c0, ref.c0, "c0")
    assert math.isinf(float(c0[-1])) and bool(packed[-1, 9] == 1e30)
    with torch.no_grad():
        feats = T.precompute_features(g, cam)
    assert feats.packed is not None and T.pack_features(feats) is feats.packed
    for f in T.FEATURE_FIELDS:
        _equal(getattr(feats, f), getattr(ref, f), f)
    return packed


@pytest.fixture(scope="module")
def scene200k():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return random_scene(200_000, seed=21, device="cuda", **LAW)


@pytest.mark.cuda
@pytest.mark.parametrize("pose", range(4))
def test_table_at_the_law(cuda, scene200k, pose):
    cam = _camera(0.4 + 2 * math.pi * pose / 4, (1920, 1088), cuda)
    packed = _same_table(scene200k, cam)
    assert (packed[:-1, 9] > 0).all()     # the orbit sees every splat


def _hard_scene(n, device, seed=0):
    """Unnormalised quaternions (|q| from 0.3 to 3), scales at the law's
    two ends, mixed per axis."""
    g = random_scene(n, seed=seed, device=device, **LAW)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    norm = torch.exp(torch.empty(n, 1).uniform_(math.log(0.3), math.log(3.0),
                                                generator=gen))
    ends = torch.tensor(LAW["scale_range"])[
        torch.randint(0, 2, (n, 3), generator=gen)]
    g.quats = (g.quats * norm.to(device)).contiguous()
    g.scales = ends.to(device)
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 50_000])
def test_table_on_hard_splats(cuda, n):
    """A camera inside the scene (half the splats behind it), and row
    counts around a block of 128."""
    g = _hard_scene(n, cuda, seed=n)
    _same_table(g, _camera(0.9, (640, 384), cuda, r=0.5))
    _same_table(g, _camera(2.2, (640, 384), cuda))


@pytest.mark.cuda
def test_table_from_unaligned_inputs(cuda):
    """Contiguous inputs that do not start on 16 bytes (the kernel reads
    their words one at a time)."""
    g = _hard_scene(3_001, cuda, seed=7)

    def shifted(x):
        flat = torch.empty(x.numel() + 1, device=cuda)
        flat[1:] = x.reshape(-1)
        return flat[1:].view(x.shape)

    g.quats, g.sh = shifted(g.quats), shifted(g.sh)
    assert g.quats.data_ptr() % 16 and g.sh.data_ptr() % 16
    _same_table(g, _camera(1.3, (640, 384), cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("res,tile,offset", [
    ((1920, 1088), (16, 16), None),
    ((1920, 1088), (16, 16), (0.3, -0.2)),
    ((500, 300), (8, 8), None),
    ((500, 300), (8, 8), (-0.45, 0.25)),
])
def test_pixel_table(cuda, res, tile, offset):
    for theta in (0.4, 2.5):
        cam = _camera(theta, res, cuda)
        before = T.pixel_table_cuda.launches
        pix = T._tile_pixel_features(cam, tile, offset)
        assert T.pixel_table_cuda.launches == before + 1
        _equal(pix, T.pixel_table_torch(cam, tile, offset), "pixel table")


@pytest.mark.cuda
@pytest.mark.parametrize("renderer", ["auto", "keys"])
def test_frame_same_with_and_without_grad(cuda, renderer):
    """The table on the chain (autograd recording) or from the kernel
    (inference mode): the same image, bit for bit."""
    from rtgs_tpu_torch.render.api import render

    g = random_scene(60_000, seed=4, device=cuda, **LAW)
    cam = _camera(0.7, (640, 384), cuda)
    kw = dict(depth=16, renderer=renderer, max_candidates=1536,
              max_global=128, tile_bands=2)
    before = T.feature_table_cuda.launches
    with torch.inference_mode():
        img = render(g, cam, **kw)
    assert T.feature_table_cuda.launches == before + 1
    for f in ("means", "quats", "scales", "colors", "opacities", "sh"):
        setattr(g, f, getattr(g, f).clone().requires_grad_())
    img_grad = render(g, cam, **kw)
    assert img_grad.requires_grad
    assert T.feature_table_cuda.launches == before + 1
    _equal(img_grad.detach(), img, "image")


@pytest.mark.cuda
def test_kernel_tables_counter(cuda):
    """features.kernel_tables: 1 a frame without grad, 0 a step's frame
    under grad."""
    from torch.profiler import ProfilerActivity, profile

    from rtgs_tpu_torch.render.api import render

    g = random_scene(30_000, seed=5, device=cuda, **LAW)
    cam = _camera(1.0, (320, 192), cuda)
    kw = dict(depth=16, max_candidates=1536, max_global=128)
    counts = {}
    for label in ("no_grad", "grad"):
        if label == "grad":
            g.colors = g.colors.clone().requires_grad_()
        profiling.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            with torch.set_grad_enabled(label == "grad"):
                render(g, cam, **kw)
        counts[label] = profiling.read()["counters"].get(
            "features.kernel_tables", 0)
    profiling.clear()
    assert counts == {"no_grad": 1, "grad": 0}


@pytest.mark.cuda
def test_wrappers_refuse_wrong_inputs(cuda):
    g = random_scene(100, seed=1, device=cuda, **LAW)
    cam = _camera(0.4, (64, 48), cuda)
    g.opacities = g.opacities.double()
    with pytest.raises(ValueError, match="opacities is torch.float64"):
        T.feature_table_cuda(g, cam)
    g.opacities = g.opacities.float()
    g.sh = g.sh.reshape(100, 45)
    with pytest.raises(ValueError, match="sh has shape"):
        T.feature_table_cuda(g, cam)
    g.sh = g.sh.reshape(100, G.NUM_SH_COEFFS, 3)
    cam.focal_length = cam.focal_length.cpu()
    with pytest.raises(ValueError, match="focal_length is on cpu"):
        T.pixel_table_cuda(cam, (16, 16))
