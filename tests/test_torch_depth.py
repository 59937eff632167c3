"""Peels deeper than one kernel's list (rtgs_tpu_torch.ops.peel: passes of
at most MAX_DEPTH layers, each above the pixel's floor, the (t1, key) of the
pass before's last winner) against one call of the plain twin at the whole
depth, and the deep renders against the JAX package's, which has no depth
limit.

The chain is exact: with MAX_DEPTH patched to 8, a peel of 20 layers runs
in three passes through the twins and must give one twin call's winners
bitwise, also where two hits tie in t1 across a pass boundary (keys: the
lower splat id first; fused and top-K: the lower candidate slot first).
The fused path composites each pass from T = 1 and chains the passes in
torch, so its radiance agrees to 1e-6 of its largest entry, not bitwise.

The scene of the renders is a thin fog: 600 splats of opacity 0.02-0.09 in
a cube of half-size 0.3 under a 20° field of view, so that a sixth of the
pixels have more than 80 hits and the layers past 64 still move the image
by up to ~0.07 (depth 64 against 80). Images against JAX by
tests/_utils.assert_images_close; scene gradients per field relative to the
field's largest entry at the 0.99 quantile, 5e-2 for rotations and scales
(the chain from the f32 table amplifies rounding there) and 1e-2 for the
rest, the gates of chip_smoke.py's phase 9."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtgs_tpu import gaussians as JG
from rtgs_tpu.camera import camera_from_fov as j_camera_from_fov
from rtgs_tpu.render.tiled import render_tiled_keys as j_render_keys
from rtgs_tpu.render.tiled import render_tiled_pallas as j_render_pallas
from rtgs_tpu.viewer.orbit import orbit_camera_pose
from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.bridge import camera_from_numpy, gaussians_from_numpy
from rtgs_tpu_torch.camera import camera_from_fov
from rtgs_tpu_torch.ops import peel
from rtgs_tpu_torch.render.binning import tile_candidates
from rtgs_tpu_torch.render.tiled import (_tile_pixel_features,
                                         pack_features, precompute_features,
                                         render_tiled_keys,
                                         render_tiled_pallas)
from rtgs_tpu_torch.scene import random_scene_arrays
from tests._utils import assert_images_close

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, RES, FOV, DEPTH = 600, (64, 48), 20.0, 80
KW = dict(tile=(16, 16), max_candidates=640, max_global=32)
FIELDS = ("means", "quats", "scales", "colors", "opacities", "sh")
SCENE_Q99, ROT_SCALE_Q99 = 1e-2, 5e-2
CHAIN_DEPTH, PASS = 20, 8
RAD_RTOL = 1e-6
TIMEOUT = 240


def _fields():
    fields = random_scene_arrays(N, 0.3, (0.05, 0.15), seed=11)
    fields["opacities"] = (fields["opacities"] * 0.1).astype(np.float32)
    return fields


def _cams():
    pos, rot, _, _ = orbit_camera_pose(0.3, 1.2, 3.0, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    jcam = j_camera_from_fov(pos, rot, RES, FOV)
    return jcam, camera_from_numpy(jcam, device="cpu")


@pytest.fixture(scope="module")
def frame():
    """The packed table, candidates and pixel features of the fog frame."""
    _, cam = _cams()
    g = gaussians_from_numpy(_fields(), device="cpu")
    packed = pack_features(precompute_features(g, cam)).detach()
    b = tile_candidates(g, cam, chunk=peel.CHUNK, **KW)
    return packed, b.candidates, _tile_pixel_features(cam, KW["tile"])


def test_pass_depths():
    assert peel.pass_depths(16) == [16]
    assert peel.pass_depths(64) == [64]
    assert peel.pass_depths(65) == [64, 1]
    assert peel.pass_depths(128) == [64, 64]
    assert peel.pass_depths(200) == [64, 64, 64, 8]
    with pytest.raises(ValueError):
        peel.pass_depths(0)


def test_the_scene_needs_more_than_one_pass(frame):
    """A sixth of the pixels hit more than DEPTH splats, and no tile
    overflows its budget."""
    packed, cand, pix = frame
    _, sid = peel.peel_keys_torch(packed, cand, pix, 4 * DEPTH)
    hits = (sid >= 0).sum(1)
    assert (hits > peel.MAX_DEPTH).float().mean() > 0.1
    assert (hits > DEPTH).float().mean() > 0.1
    assert int((cand >= 0).sum(1).max()) < KW["max_candidates"]


def test_binning_lists_a_splat_once_a_tile(frame):
    """The keys chain's floor is (t1, splat id): it relies on a tile's list
    naming each splat at most once."""
    _, cand, _ = frame
    for row in cand:
        ids = row[row >= 0]
        assert ids.unique().numel() == ids.numel()


def test_keys_chain_is_one_twin_call(frame, monkeypatch):
    packed, cand, pix = frame
    t1_ref, sid_ref = peel.peel_keys_torch(packed, cand, pix, CHAIN_DEPTH)
    monkeypatch.setattr(peel, "MAX_DEPTH", PASS)
    t1, sid = peel.peel_keys(packed, cand, pix, CHAIN_DEPTH)
    assert t1.shape == (cand.shape[0], CHAIN_DEPTH, pix.shape[1])
    assert (sid_ref[:, PASS:] >= 0).any()    # the later passes find hits
    assert torch.equal(t1, t1_ref) and torch.equal(sid, sid_ref)


def test_topk_chain_is_one_twin_call(frame, monkeypatch):
    packed, cand, pix = frame
    layers_ref, _ = peel.peel_topk_torch(packed, cand, pix, CHAIN_DEPTH)
    monkeypatch.setattr(peel, "MAX_DEPTH", PASS)
    got = torch.stack(peel.peel_topk(packed, cand, pix, CHAIN_DEPTH), dim=1)
    assert torch.equal(got, layers_ref.transpose(2, 3))


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def test_fused_chain_is_one_twin_call(frame, monkeypatch):
    """Radiance and transmittance to RAD_RTOL; the table gradient of a
    weighted sum through the chained backwards against the one call's, to
    1e-5 of each lane's largest entry (the passes' cotangents carry the
    transmittance of the passes before, rounded otherwise)."""
    packed, cand, pix = frame
    w = torch.from_numpy(np.random.default_rng(3).uniform(
        0.5, 1.5, (cand.shape[0], 3, pix.shape[1])).astype(np.float32))

    def run():
        x = packed.clone().requires_grad_()
        rad, trans = peel.peel_fused(x, cand, pix, CHAIN_DEPTH)
        ((rad * w).sum() + trans.sum()).backward()
        return rad.detach(), trans.detach(), x.grad

    rad_ref, trans_ref, grad_ref = run()
    slots_ref = peel.select_slots(packed, cand, pix, CHAIN_DEPTH)
    monkeypatch.setattr(peel, "MAX_DEPTH", PASS)
    rad, trans, grad = run()
    assert _rel(rad, rad_ref) < RAD_RTOL
    assert float((trans - trans_ref).abs().max()) < RAD_RTOL
    scale = grad_ref.abs().amax(0).clamp(min=1e-30)
    assert float(((grad - grad_ref).abs() / scale).max()) < 1e-5
    # The passes' slots, chained by hand through their floors.
    slots, floor = [], None
    for k in peel.pass_depths(CHAIN_DEPTH):
        t1, s = peel._select(packed, cand, pix, k, floor)
        slots.append(s)
        floor = (t1[:, -1].contiguous(), s[:, -1].contiguous())
    assert torch.equal(torch.cat(slots, dim=1), slots_ref)


def _tie_frame():
    """One 16×16 tile looking down −z at 12 spheres (scale 0.3) on the axis, at
    depths 2, 3, ..., the 8th and 9th one sphere twice: splats 7 and 8, the
    same row, so their t1 tie in f32 on every pixel. Splat 8 sits in an
    earlier candidate slot than splat 7, so the two tie rules disagree:
    the keys path lists splat 7 first (lower id), the slot paths splat 8
    (lower slot). With passes of 8 the tie straddles the first boundary."""
    n = 12
    depth = np.arange(2.0, 2.0 + n, dtype=np.float32)
    depth[8] = depth[7]
    fields = {
        "means": np.stack([np.zeros(n), np.zeros(n), -depth], -1),
        "quats": np.tile([0.0, 0.0, 0.0, 1.0], (n, 1)),
        "scales": np.full((n, 3), 0.3),
        "colors": np.linspace(0.1, 0.9, 3 * n).reshape(n, 3),
        "opacities": np.full(n, 0.05),
        "sh": np.zeros((n, 15, 3)),
    }
    fields["colors"][8] = (1.0, 0.0, 0.0)
    g = G.new_gaussians(**{k: np.asarray(v, np.float32)
                           for k, v in fields.items()}, device="cpu")
    cam = camera_from_fov(np.zeros(3, np.float32),
                          np.array([0.0, 0.0, 0.0, 1.0], np.float32),
                          (16, 16), 2.0, device="cpu")
    packed = pack_features(precompute_features(g, cam)).detach()
    order = [0, 1, 2, 3, 4, 5, 6, 8, 7, 9, 10, 11]
    cand = torch.full((1, peel.CHUNK), -1, dtype=torch.int32)
    cand[0, :n] = torch.tensor(order, dtype=torch.int32)
    return packed, cand, _tile_pixel_features(cam, (16, 16))


def test_tie_across_a_pass_boundary(monkeypatch):
    packed, cand, pix = _tie_frame()
    depth = 12
    t1_ref, sid_ref = peel.peel_keys_torch(packed, cand, pix, depth)
    slots_ref = peel.select_slots(packed, cand, pix, depth)
    layers_ref, _ = peel.peel_topk_torch(packed, cand, pix, depth)
    rad_ref, trans_ref, _ = peel.peel_fused_torch(packed, cand, pix, depth)
    # Every pixel sees the 12 spheres; the tie sits at layers 7 and 8.
    assert bool((sid_ref >= 0).all())
    assert bool((t1_ref[:, PASS - 1] == t1_ref[:, PASS]).all())
    assert bool((sid_ref[:, PASS - 1] == 7).all())
    assert bool((sid_ref[:, PASS] == 8).all())
    assert bool((slots_ref[:, PASS - 1] == 7).all())   # splat 8's slot
    assert bool((slots_ref[:, PASS] == 8).all())       # splat 7's slot
    monkeypatch.setattr(peel, "MAX_DEPTH", PASS)
    t1, sid = peel.peel_keys(packed, cand, pix, depth)
    assert torch.equal(t1, t1_ref) and torch.equal(sid, sid_ref)
    got = torch.stack(peel.peel_topk(packed, cand, pix, depth), dim=1)
    assert torch.equal(got, layers_ref.transpose(2, 3))
    rad, trans = peel.peel_fused(packed, cand, pix, depth)
    assert _rel(rad, rad_ref) < RAD_RTOL
    assert float((trans - trans_ref).abs().max()) < RAD_RTOL


def test_vacant_floor_admits_nothing(frame):
    """A floor whose t1 is +inf (a pass that ran out of hits) lists no hit,
    whatever its key: -1 as the wrapper writes it or INT_MAX."""
    packed, cand, pix = frame
    t, p = cand.shape[0], pix.shape[1]
    for key in (-1, 2**31 - 1):
        floor = (torch.full((t, p), float("inf")),
                 torch.full((t, p), key, dtype=torch.int32))
        t1, sid = peel.peel_keys_torch(packed, cand, pix, 4, floor)
        assert bool(torch.isinf(t1).all()) and bool((sid == -1).all())
        slots = peel.select_slots(packed, cand, pix, 4, floor)
        assert bool((slots == -1).all())


def _jscene(fields):
    return JG.Gaussians(**{k: jnp.asarray(v) for k, v in fields.items()})


@pytest.mark.parametrize("path", ["keys", "pallas"])
def test_deep_render_matches_jax(path):
    fields = _fields()
    jcam, tcam = _cams()
    j_render = j_render_keys if path == "keys" else j_render_pallas
    t_render = render_tiled_keys if path == "keys" else render_tiled_pallas
    ref = np.asarray(j_render(_jscene(fields), jcam, depth=DEPTH, **KW))
    img = t_render(gaussians_from_numpy(fields, device="cpu"), tcam,
                   depth=DEPTH, **KW)
    shallow = t_render(gaussians_from_numpy(fields, device="cpu"), tcam,
                       depth=peel.MAX_DEPTH, **KW)
    assert img.shape == (RES[0], RES[1], 3) and bool(torch.isfinite(img).all())
    # The layers past one pass move the image: the comparison sees them.
    assert float((img - shallow).abs().max()) > 1e-2
    assert_images_close(img.numpy(), ref)


def _scene_grads_torch(fields, tcam, render):
    leaves = {f: torch.from_numpy(fields[f].copy()).requires_grad_()
              for f in FIELDS}
    g = G.Gaussians(mask=torch.from_numpy(fields["mask"].copy()), **leaves)
    render(g, tcam, depth=DEPTH, **KW).sum().backward()
    return {f: leaves[f].grad.double().numpy() for f in FIELDS}


def _scene_grads_jax(fields, jcam, render):
    gj = jax.grad(lambda g: jnp.sum(render(g, jcam, depth=DEPTH, **KW)))(
        _jscene(fields))
    return {f: np.asarray(getattr(gj, f), np.float64) for f in FIELDS}


@pytest.mark.parametrize("path", ["keys", "pallas"])
def test_deep_scene_gradients_match_jax(path):
    fields = _fields()
    jcam, tcam = _cams()
    j_render = j_render_keys if path == "keys" else j_render_pallas
    t_render = render_tiled_keys if path == "keys" else render_tiled_pallas
    got = _scene_grads_torch(fields, tcam, t_render)
    ref = _scene_grads_jax(fields, jcam, j_render)
    for f in FIELDS:
        assert np.isfinite(got[f]).all(), f
        scale = np.abs(ref[f]).max()
        assert scale > 0, f
        q = np.quantile(np.abs(got[f] - ref[f]) / scale, 0.99)
        gate = ROT_SCALE_Q99 if f in ("quats", "scales") else SCENE_Q99
        assert q < gate, (f, q)


_RING_WORKER = r"""
import os, sys
sys.path.insert(0, sys.argv[1])
tmp, rank = sys.argv[2], int(sys.argv[3])
import numpy as np
import torch
torch.set_num_threads(1)
from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.bridge import camera_from_numpy
from rtgs_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from rtgs_tpu_torch.parallel.render import render_tiled_sharded, shard_scene

initialize_distributed(f"file://{tmp}/store", 2, rank, device="cpu")
mesh = make_mesh(1, 2, device="cpu")
inp = np.load(os.path.join(tmp, "inputs.npz"))
g = G.Gaussians(**{f: torch.from_numpy(inp[f]) for f in G.FIELDS})
cam = camera_from_numpy({k: inp["cam_" + k] for k in
                         ("position", "rotation", "focal_length",
                          "buf_size")}, device="cpu")
with torch.no_grad():
    img = render_tiled_sharded(shard_scene(g, mesh), cam, mesh,
                               depth=int(inp["depth"]), tile=(16, 16),
                               max_candidates=int(inp["max_candidates"]),
                               max_global=int(inp["max_global"]))
assert "jax" not in sys.modules and "rtgs_tpu" not in sys.modules
np.save(os.path.join(tmp, f"rank{rank}.npy"), img.numpy())
torch.distributed.destroy_process_group()
"""


def test_deep_ring_matches_single_device(tmp_path):
    """The keys-path ring on a 1×2 mesh of gloo processes at depth 80: each
    shard's keys stage chains its passes, the ring merges the shards'
    lists along K; the image against the port's single-device render to
    1e-5 (tests/test_torch_parallel.py's tolerance)."""
    fields = _fields()
    jcam, tcam = _cams()
    np.savez(tmp_path / "inputs.npz", **fields,
             **{"cam_" + k: np.asarray(getattr(jcam, k))
                for k in ("position", "rotation", "focal_length",
                          "buf_size")},
             depth=DEPTH, max_candidates=KW["max_candidates"],
             max_global=KW["max_global"])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RING_WORKER, str(ROOT), str(tmp_path),
         str(rank)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    with torch.no_grad():
        ref = render_tiled_keys(gaussians_from_numpy(fields, device="cpu"),
                                tcam, depth=DEPTH, **KW).numpy()
    for rank in range(2):
        img = np.load(tmp_path / f"rank{rank}.npy")
        np.testing.assert_allclose(img, ref, atol=1e-5)
