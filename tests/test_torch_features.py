"""The features layer's dispatch on the CPU, and its written-out plain
chains against the forms they replaced.

On CPU tensors the layer runs its plain chains (no kernel launches and no
kernel table counted); the kernels' wrappers refuse CPU tensors; the fields
of a kernel-written table (views of it) are the chain's fields, ``c0``'s inf
sentinel included; and each form written out one elementwise operation at a
time for the kernels to repeat (the rotation columns, |q|², the SH basis,
the pixel rays) equals the library form it replaced to the JAX comparison
tests' tolerance (rtol 1e-5, atol 1e-6). The bitwise comparisons run on the
card: ``tests/test_torch_features_cuda.py``."""

import math
import pathlib
import re

import numpy as np
import pytest
import torch

from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.camera import camera_from_fov
from rtgs_tpu_torch.render import tiled as T
from rtgs_tpu_torch.scene import random_scene
from rtgs_tpu_torch.utils import profiling
from rtgs_tpu_torch.utils import quaternion as quat
from rtgs_tpu_torch.viewer.orbit import orbit_camera_pose

RTOL, ATOL = 1e-5, 1e-6


def _camera(theta=0.4, res=(40, 24)):
    pos, rot, _, _ = orbit_camera_pose(theta, 1.2, 5.0, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    return camera_from_fov(pos, rot, res, 60.0, device="cpu")


def _scene(n=300, seed=2):
    return random_scene(n, extent=2.0, scale_range=(0.005, 0.03), seed=seed,
                        device="cpu")


def test_cpu_takes_the_plain_chains():
    """No kernel launch, no kernel table counted, no table carried."""
    from torch.profiler import ProfilerActivity, profile

    from rtgs_tpu_torch.render.api import render

    g, cam = _scene(), _camera()
    launches = (T.feature_table_cuda.launches, T.pixel_table_cuda.launches)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        feats = T.precompute_features(g, cam)
        render(g, cam, renderer="pallas", max_candidates=256)
        counters = profiling.read()["counters"]
    profiling.clear()
    assert feats.packed is None
    assert counters.get("features.kernel_tables", 0) == 0
    assert (T.feature_table_cuda.launches,
            T.pixel_table_cuda.launches) == launches


@pytest.mark.parametrize("wrapper", ["feature_table_cuda", "pixel_table_cuda"])
def test_cuda_wrappers_refuse_cpu_tensors(wrapper):
    g, cam = _scene(10), _camera()
    call = {"feature_table_cuda": lambda: T.feature_table_cuda(g, cam),
            "pixel_table_cuda": lambda: T.pixel_table_cuda(cam, (16, 16))}
    before = getattr(T, wrapper).launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        call[wrapper]()
    assert getattr(T, wrapper).launches == before


def test_table_fields_are_the_chains():
    """The fields of a table as the kernel hands it back (views of it,
    with the separate c0) are the chain's fields, c0's inf sentinel
    included; ``pack_features`` returns that table itself."""
    feats = T.precompute_features(_scene(), _camera())
    assert feats.c0[-1] == math.inf and torch.isfinite(feats.c0[:-1]).all()
    packed = T.pack_features(feats)
    assert packed[-1, 9] == 1e30
    views = T.table_features(packed, feats.c0)
    assert T.pack_features(views) is packed
    for f in T.FEATURE_FIELDS:
        a, b = getattr(views, f), getattr(feats, f)
        assert a.shape == b.shape and torch.equal(a, b), f


def _old_sh_basis(dirs):
    """gaussians.sh_basis as it was, with powers."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    return torch.stack([
        0.5 * G.C_0 * y, 0.5 * G.C_0 * z, 0.5 * G.C_0 * x,
        0.5 * G.C_1 * x * y, 0.5 * G.C_1 * y * z,
        0.25 * G.C_2 * (3 * z**2 - 1), 0.5 * G.C_1 * x * z,
        0.25 * G.C_1 * (x**2 - y**2), 0.25 * G.C_3 * y * (3 * x**2 - y**2),
        0.5 * G.C_4 * x * y * z, 0.25 * G.C_5 * y * (5 * z**2 - 1),
        0.25 * G.C_6 * (5 * z**2 - 3 * z), 0.25 * G.C_5 * x * (5 * z**2 - 1),
        0.25 * G.C_4 * (x**2 - y**2) * z,
        0.25 * G.C_3 * x * (x**2 - 3 * y**2)], dim=-1)


def _old_direct6(quats, scales):
    """inv_covariance_direct6 as it was: the library's rotation matrix and
    a library sum for |q|²."""
    mx, my, mz = quat.as_rotation_mat3(quats).unbind(-1)
    qq = (quats * quats).sum(-1)
    inv = 1.0 / (qq * qq)
    cols = [c * (inv / scales[..., k])[:, None]
            for k, c in enumerate((mx, my, mz))]
    return torch.stack([sum(c[:, i] * c[:, j] for c in cols)
                        for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2),
                                     (2, 2))], dim=-1)


def _old_pixel_table(camera, tile, pixel_offset):
    """_tile_pixel_features as it was: division by Python ints, the
    library's norm and quaternion sandwich."""
    w, h = camera.buf_size
    tw, th = tile
    ntx, nty = -(-w // tw), -(-h // th)
    censor = torch.tensor((w, h), dtype=torch.float32)
    ox, oy = (0.0, 0.0) if pixel_offset is None else pixel_offset
    i = (torch.arange(ntx * tw, dtype=torch.float32) + 0.5 + ox) / w
    j = (torch.arange(nty * th, dtype=torch.float32) + 0.5 + oy) / h
    uv = torch.stack(torch.meshgrid(i, j, indexing="ij"), dim=-1)
    pxy = (censor * uv - 0.5 * censor) / camera.focal_length
    d_cam = torch.cat([pxy, -torch.ones_like(pxy[..., :1])], dim=-1)
    d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    dirs = quat.rot_vec3(camera.rotation, d_cam)
    fd, y = T.direction_features(dirs)
    pix = torch.cat([dirs, fd, _old_sh_basis(dirs)], dim=-1)
    return (pix.reshape(ntx, tw, nty, th, 24).permute(0, 2, 1, 3, 4)
            .reshape(ntx * nty, tw * th, 24))


def _rotation_columns_pair():
    q = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4096, 4)).astype(np.float32))
    cols = quat.rotation_columns(q)
    mine = torch.stack([torch.stack(cols[i], -1) for i in range(3)], -1)
    return mine, quat.as_rotation_mat3(q)


def _sh_basis_pair():
    d = torch.from_numpy(np.random.default_rng(6).normal(
        size=(4096, 3)).astype(np.float32))
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return G.sh_basis(d), _old_sh_basis(d)


def _direct6_pair():
    g = _scene(4096, seed=7)
    quats = g.quats * torch.linspace(0.5, 2.0, g.num)[:, None]
    got = torch.stack(G.inv_covariance_direct6(quats, g.scales), dim=-1)
    want = _old_direct6(quats, g.scales)
    scale = want.abs().amax(-1, keepdim=True)
    return got / scale, want / scale


def _pixel_pair(offset):
    cam = _camera(1.1, (50, 30))
    return (T.pixel_table_torch(cam, (8, 8), offset),
            _old_pixel_table(cam, (8, 8), offset))


WRITTEN_OUT = {
    "rotation_columns": _rotation_columns_pair,
    "sh_basis": _sh_basis_pair,
    "inv_covariance_direct6": _direct6_pair,
    "pixel_table": lambda: _pixel_pair(None),
    "pixel_table_jittered": lambda: _pixel_pair((0.3, -0.2)),
}


@pytest.mark.parametrize("form", sorted(WRITTEN_OUT))
def test_written_out_forms_equal_the_old_ones(form):
    got, want = WRITTEN_OUT[form]()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_kernel_constants_are_pythons():
    """features.cu's SH constants are gaussians.py's doubles, digit for
    digit (each is rounded to f32 once, as torch rounds a Python
    scalar)."""
    src = (pathlib.Path(T.__file__).resolve().parents[1] / "ops" / "csrc"
           / "features.cu").read_text()
    found = dict(re.findall(r"constexpr double kC(\d) = ([0-9.e+-]+);", src))
    assert sorted(found) == [str(k) for k in range(7)]
    for k, text in found.items():
        assert float(text) == getattr(G, f"C_{k}"), k
