"""The port's multi-device renderer (rtgs_tpu_torch.parallel) against the
JAX package's: the mesh's errors, then the oracle ring and the keys-path
ring on meshes of 2×1, 1×2 and 2×2 as gloo processes on the CPU, against
the JAX functions (the JAX ring on the same mesh shape over the virtual
CPU devices of tests/conftest.py) and against the port's single-device
keys render; the ring's scene gradients at 2×2; the merge's tie order; the
port's launcher (the cases of tests/test_launcher.py), and ``render
--mesh 2,1`` through the CLI under it.

The worker processes import no JAX: each is a ``python -c`` script that
joins a ``torch.distributed`` world through a ``file://`` store in the
test's directory, runs every check's ring, and writes one ``.npz``; one
launch a mesh shape serves all of that shape's tests."""

import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtgs_tpu import gaussians as JG
from rtgs_tpu.camera import camera_from_fov
from rtgs_tpu.parallel.mesh import make_mesh as j_make_mesh
from rtgs_tpu.parallel.render import _merge_layers as j_merge_layers
from rtgs_tpu.parallel.render import render_tiled_sharded as j_ring
from rtgs_tpu.parallel.render import shard_scene as j_shard_scene
from rtgs_tpu.rays import new_rays as j_new_rays
from rtgs_tpu.render.oracle import composite_rays as j_composite_rays
from rtgs_tpu.scene import pad_scene as j_pad_scene
from rtgs_tpu.viewer.orbit import orbit_camera_pose
from rtgs_tpu_torch.bridge import camera_from_numpy, gaussians_from_numpy
from rtgs_tpu_torch.parallel.launcher import HEARTBEAT_ENV, launch
from rtgs_tpu_torch.parallel.mesh import PRIMS_AXIS, RAYS_AXIS, make_mesh
from rtgs_tpu_torch.parallel.render import merge_layers
from rtgs_tpu_torch.rays import new_rays
from rtgs_tpu_torch.render.oracle import composite_rays
from rtgs_tpu_torch.render.tiled import render_tiled_keys
from rtgs_tpu_torch.scene import random_scene_arrays, save_scene
from tests._utils import assert_images_close

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = [(2, 1), (1, 2), (2, 2)]
N, RES, DEPTH, N_RAYS = 160, (64, 32), 8, 64
BUDGETS = dict(tile=(16, 16), max_candidates=128, max_global=64)
FIELDS = ("means", "quats", "scales", "colors", "opacities", "sh")
ATOL = 1e-5
# Scene gradients through the ring against the single-device keys path
# (tests/test_parallel.py:178-184): each field's error relative to its
# largest entry, at the 0.99 quantile and at most.
GRAD_Q99, GRAD_MAX = 5e-3, 5e-2
TIMEOUT = 240

_WORKER = r"""
import os, sys
sys.path.insert(0, sys.argv[1])
tmp, n_rays, n_prims, rank = (sys.argv[2], int(sys.argv[3]),
                              int(sys.argv[4]), int(sys.argv[5]))
import numpy as np
import torch
torch.set_num_threads(1)
from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.bridge import camera_from_numpy
from rtgs_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from rtgs_tpu_torch.parallel.render import (render_sharded,
                                            render_tiled_sharded,
                                            shard_scene)
from rtgs_tpu_torch.rays import new_rays

world = n_rays * n_prims
initialize_distributed(f"file://{tmp}/store", world, rank, device="cpu")
mesh = make_mesh(n_rays, n_prims, device="cpu")
assert mesh.rank == rank and mesh.shape == {"rays": n_rays, "prims": n_prims}
inp = np.load(os.path.join(tmp, "inputs.npz"))
fields = {f: torch.from_numpy(inp[f]) for f in G.FIELDS}
cam = camera_from_numpy({k: inp["cam_" + k] for k in
                         ("position", "rotation", "focal_length",
                          "buf_size")}, device="cpu")
kw = dict(depth=int(inp["depth"]), tile=(16, 16),
          max_candidates=int(inp["max_candidates"]),
          max_global=int(inp["max_global"]))
out = {}
rays = new_rays(torch.from_numpy(inp["ray_o"]),
                torch.from_numpy(inp["ray_d"]), device="cpu")
with torch.no_grad():
    for tag, prefix in (("", ""), ("_tie", "tie_")):
        g = G.Gaussians(**{f: torch.from_numpy(inp[prefix + f])
                           for f in G.FIELDS})
        shard = shard_scene(g, mesh)
        out["oracle_rad" + tag], out["oracle_trans" + tag] = (
            x.numpy() for x in render_sharded(shard, rays, kw["depth"],
                                              mesh))
        out["image" + tag] = render_tiled_sharded(shard, cam, mesh,
                                                  **kw).numpy()
if inp["grads"]:
    leaves = {f: v.clone().requires_grad_(f != "mask")
              for f, v in fields.items()}
    img = render_tiled_sharded(shard_scene(G.Gaussians(**leaves), mesh),
                               cam, mesh, **kw)
    (img ** 2).sum().backward()
    for f, v in leaves.items():
        if f != "mask":
            out["grad_" + f] = v.grad.numpy()
assert "jax" not in sys.modules and "rtgs_tpu" not in sys.modules
np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
torch.distributed.destroy_process_group()
print(f"OK rank {rank}", flush=True)
"""


def _inputs():
    fields = random_scene_arrays(N, 1.0, (0.02, 0.1), seed=5)
    pos, rot, _, _ = orbit_camera_pose(0.3, 1.2, 3.0, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    jcam = camera_from_fov(pos, rot, RES, 60.0)
    rng = np.random.default_rng(6)
    origins = rng.uniform(-3, 3, (N_RAYS, 3)).astype(np.float32)
    dirs = -origins / np.linalg.norm(origins, axis=-1, keepdims=True)
    return fields, jcam, origins, dirs


def _tie_scene(fields):
    """The scene with splat N−1 made a copy of splat 0 in another color,
    both at the origin in front of every camera: their t1 tie on every ray
    through them, across the two halves of the prims axis."""
    tie = {k: v.copy() for k, v in fields.items()}
    for i, color in ((0, (0.0, 0.0, 1.0)), (N - 1, (1.0, 0.0, 0.0))):
        tie["means"][i] = 0.0
        tie["quats"][i] = fields["quats"][0]
        tie["scales"][i] = 0.15
        tie["colors"][i] = color
        tie["opacities"][i] = 0.9
        tie["sh"][i] = 0.0
    return tie


def _run_workers(tmp: pathlib.Path, n_rays: int, n_prims: int,
                 grads: bool):
    fields, jcam, origins, dirs = _inputs()
    tie = {"tie_" + k: v for k, v in _tie_scene(fields).items()}
    np.savez(tmp / "inputs.npz", **fields, **tie,
             **{"cam_" + k: np.asarray(getattr(jcam, k))
                for k in ("position", "rotation", "focal_length",
                          "buf_size")},
             ray_o=origins, ray_d=dirs, depth=DEPTH, grads=grads,
             max_candidates=BUDGETS["max_candidates"],
             max_global=BUDGETS["max_global"])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(ROOT), str(tmp), str(n_rays),
         str(n_prims), str(rank)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for rank in range(n_rays * n_prims)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    return [dict(np.load(tmp / f"rank{r}.npz"))
            for r in range(n_rays * n_prims)]


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    """``rings((n_rays, n_prims))`` → the ranks' results, one launch a mesh
    shape for the whole module (gradients on the 2×2 mesh)."""
    done = {}

    def get(shape):
        if shape not in done:
            tmp = tmp_path_factory.mktemp(f"ring{shape[0]}x{shape[1]}")
            done[shape] = _run_workers(tmp, *shape, grads=shape == (2, 2))
        return done[shape]
    return get


mesh_shapes = pytest.mark.parametrize("shape", MESHES,
                                      ids=lambda m: f"{m[0]}x{m[1]}")


def _jax_scene():
    fields, jcam, origins, dirs = _inputs()
    jg = JG.Gaussians(**{k: jnp.asarray(v) for k, v in fields.items()})
    return fields, jg, jcam, origins, dirs


def test_make_mesh_errors():
    """tests/test_parallel.py:22 in one process: a 1×1 mesh, and the JAX
    function's errors for too few processes and a prims axis that does
    not divide them."""
    mesh = make_mesh(1, 1, device="cpu")
    assert mesh.shape == {RAYS_AXIS: 1, PRIMS_AXIS: 1}
    assert make_mesh(0, 1, device="cpu").shape == mesh.shape
    with pytest.raises(ValueError):
        make_mesh(8, 2, device="cpu")
    with pytest.raises(ValueError):
        make_mesh(0, 2, device="cpu")
    with pytest.raises(ValueError):
        j_make_mesh(8, 2)


@mesh_shapes
def test_every_rank_holds_the_result(rings, shape):
    ranks = rings(shape)
    for key in ("image", "oracle_rad", "oracle_trans", "image_tie",
                "oracle_rad_tie", "oracle_trans_tie"):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)


@mesh_shapes
def test_render_sharded_matches_jax_oracle(rings, shape):
    """tests/test_parallel.py:32: the oracle ring against JAX
    ``composite_rays`` of the padded scene, atol 1e-5."""
    ranks, n_prims = rings(shape), shape[1]
    _, jg, _, origins, dirs = _jax_scene()
    ref_rad, ref_trans = j_composite_rays(
        j_pad_scene(jg, n_prims), j_new_rays(origins, dirs), depth=DEPTH)
    np.testing.assert_allclose(ranks[0]["oracle_rad"], np.asarray(ref_rad),
                               atol=ATOL)
    np.testing.assert_allclose(ranks[0]["oracle_trans"],
                               np.asarray(ref_trans), atol=ATOL)


@mesh_shapes
def test_tiled_sharded_matches_port_keys(rings, shape):
    """tests/test_parallel.py:119: the keys-path ring against the port's
    single-device keys render, atol 1e-5."""
    ranks = rings(shape)
    fields, _, jcam, _, _ = _jax_scene()
    ref = render_tiled_keys(gaussians_from_numpy(fields, device="cpu"),
                            camera_from_numpy(jcam, device="cpu"),
                            depth=DEPTH, **BUDGETS)
    assert ranks[0]["image"].shape == (RES[0], RES[1], 3)
    assert np.abs(ranks[0]["image"]).max() > 0.1
    np.testing.assert_allclose(ranks[0]["image"], ref.numpy(), atol=ATOL)


@mesh_shapes
def test_tiled_sharded_matches_jax_ring(rings, shape):
    """The keys-path ring against the JAX ring on the same mesh shape over
    the virtual CPU devices. The JAX keys stage takes t1 in f32 from the
    adjugate Σ⁻¹, the port in float64 from the direct form, which flips
    a few grazing silhouette pixels: the image statistic the port's
    single-device keys render is held to against JAX's
    (tests/test_torch_render.py)."""
    ranks = rings(shape)
    _, jg, jcam, _, _ = _jax_scene()
    mesh = j_make_mesh(*shape)
    ref = j_ring(j_shard_scene(jg, mesh), jcam, mesh, depth=DEPTH,
                 **BUDGETS)
    assert_images_close(ranks[0]["image"], np.asarray(ref))


@mesh_shapes
def test_cross_shard_tie_matches_single_device(rings, shape):
    """Two splats of one geometry in the two halves of the scene: every
    rank, whatever order the shards reach it in, keeps the lower splat id
    first, as the single-device keys path and oracle do; bitwise equal
    images (the JAX ring keeps the running list's layer and its
    prims-ranks disagree here)."""
    ranks = rings(shape)
    fields, _, jcam, origins, dirs = _jax_scene()
    g = gaussians_from_numpy(_tie_scene(fields), device="cpu")
    with torch.no_grad():
        ref = render_tiled_keys(g, camera_from_numpy(jcam, device="cpu"),
                                depth=DEPTH, **BUDGETS)
        ref_rad, ref_trans = composite_rays(g, new_rays(origins, dirs,
                                                        device="cpu"),
                                            depth=DEPTH)
    alone = render_tiled_keys(gaussians_from_numpy(fields, device="cpu"),
                              camera_from_numpy(jcam, device="cpu"),
                              depth=DEPTH, **BUDGETS)
    assert not torch.equal(ref, alone)          # the pair is in view
    for r in ranks:
        np.testing.assert_array_equal(r["image_tie"], ref.numpy())
        np.testing.assert_allclose(r["oracle_rad_tie"], ref_rad.numpy(),
                                   atol=ATOL)
        np.testing.assert_allclose(r["oracle_trans_tie"], ref_trans.numpy(),
                                   atol=ATOL)


def _ring_grads(ranks, n_prims):
    """The whole scene's gradient from the rays-row 0 ranks' shards."""
    return {f: sum(ranks[p]["grad_" + f] for p in range(n_prims))
            for f in FIELDS}


def test_ring_gradients_match_single_device(rings):
    """tests/test_parallel.py:148 at 2×2: scene gradients of Σ image²
    through the ring against the port's single-device keys path, at the
    gates of tests/test_parallel.py:178-184. A gradient n_rays times too
    large (a gather whose backward sums every rank's cotangent) or one
    missing the other rays-rank's tiles (no all-reduce) fails them."""
    ranks, n_prims = rings((2, 2)), 2
    fields, _, jcam, _, _ = _jax_scene()
    leaves = {f: torch.from_numpy(v).requires_grad_(f in FIELDS)
              for f, v in fields.items()}
    from rtgs_tpu_torch import gaussians as G

    img = render_tiled_keys(G.Gaussians(**leaves),
                            camera_from_numpy(jcam, device="cpu"),
                            depth=DEPTH, **BUDGETS)
    (img ** 2).sum().backward()
    got = _ring_grads(ranks, n_prims)
    for f in FIELDS:
        a, b = got[f], leaves[f].grad.numpy()
        assert np.isfinite(a).all(), f
        rel = np.abs(a - b) / (np.abs(b).max() + 1e-8)
        assert np.quantile(rel, 0.99) < GRAD_Q99, f
        assert rel.max() < GRAD_MAX, f
        assert np.abs(b).max() > 0, f


def test_ring_gradients_replicated_over_rays(rings):
    """Both rays-ranks of a prims-column hold the same shard, so after the
    all-reduce they hold the same (summed) gradient."""
    ranks, n_prims = rings((2, 2)), 2
    for p in range(n_prims):
        for f in FIELDS:
            np.testing.assert_array_equal(ranks[p]["grad_" + f],
                                          ranks[n_prims + p]["grad_" + f],
                                          err_msg=f)


def test_merge_matches_jax_without_ties():
    """Where no two t1 tie, the merge keeps what the JAX merge keeps: the
    port in (T, K, P) layout with a splat-id layer, JAX in (T, P, K)."""
    rng = np.random.default_rng(3)
    k, t, p = 4, 2, 5
    t1 = np.sort(rng.permutation(2 * k * t * p).reshape(t, 2, k, p)
                 .astype(np.float32), 2)
    ids = rng.permutation(2 * k * t * p).reshape(t, 2, k, p)
    pay = rng.uniform(size=(4, t, 2, k, p)).astype(np.float32)
    best = [t1[:, 0], ids[:, 0]] + [x[:, 0] for x in pay]
    new = [t1[:, 1], ids[:, 1]] + [x[:, 1] for x in pay]
    got = merge_layers([torch.from_numpy(x) for x in best],
                       [torch.from_numpy(x) for x in new], k, dim=1)
    drop_ids = [best[0]] + best[2:], [new[0]] + new[2:]
    ref = j_merge_layers(*([jnp.asarray(x.transpose(0, 2, 1)) for x in lst]
                           for lst in drop_ids), k)
    for a, b in zip(got[:1] + got[2:], ref):
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(b).transpose(0, 2, 1))


def test_merge_breaks_ties_by_splat_id():
    """On a tie in t1 the lower splat id wins, from either list; a vacancy
    (id −1, t1 +inf) never displaces a hit."""
    inf = float("inf")
    best = (torch.tensor([[1.0, 2.0, inf]]), torch.tensor([[7, 3, -1]]),
            torch.tensor([[0.1, 0.2, 0.0]]))
    new = (torch.tensor([[1.0, 2.0, 5.0]]), torch.tensor([[4, 9, 11]]),
           torch.tensor([[0.4, 0.9, 0.5]]))
    t1, ids, alpha = merge_layers(best, new, 3, dim=1)
    assert t1.tolist() == [[1.0, 1.0, 2.0]]
    assert ids.tolist() == [[4, 7, 3]]
    assert alpha.tolist() == [[pytest.approx(0.4), pytest.approx(0.1),
                               pytest.approx(0.2)]]


def test_merge_oracle_lists_with_rgb():
    """The oracle ring's (P, K) lists carry an rgb axis along."""
    best = (torch.tensor([[1.0, 3.0]]), torch.tensor([[2, 5]]),
            torch.tensor([[0.1, 0.3]]),
            torch.tensor([[[1.0] * 3, [3.0] * 3]]))
    new = (torch.tensor([[1.0, 2.0]]), torch.tensor([[1, 6]]),
           torch.tensor([[0.5, 0.2]]),
           torch.tensor([[[5.0] * 3, [2.0] * 3]]))
    t1, ids, alpha, rgb = merge_layers(best, new, 2, dim=1)
    assert t1.tolist() == [[1.0, 1.0]] and ids.tolist() == [[1, 2]]
    assert rgb[0, :, 0].tolist() == [5.0, 1.0]


def _worker(code: str):
    return [sys.executable, "-c", code]


def test_launcher_all_ranks_succeed():
    rc = launch(_worker("import os; print(os.environ['RANK'], "
                        "os.environ['WORLD_SIZE'], os.environ['MASTER_PORT'])"),
                num_processes=2, coordinator="localhost:0")
    assert rc == 0


def test_launcher_fail_fast_on_worker_death():
    """Rank 1 dies → rank 0 (sleeping) must be torn down quickly."""
    code = (
        "import os, time\n"
        "if os.environ['RANK'] == '1':\n"
        "    raise SystemExit(3)\n"
        "time.sleep(600)\n")
    t0 = time.time()
    rc = launch(_worker(code), num_processes=2, coordinator="localhost:0",
                poll_s=0.2)
    assert rc == 1
    assert time.time() - t0 < 60


def test_launcher_fail_fast_on_stale_heartbeat():
    """A rank that beats once then hangs trips the heartbeat timeout."""
    code = (
        "import os, pathlib, time\n"
        f"pathlib.Path(os.environ['{HEARTBEAT_ENV}']).touch()\n"
        "time.sleep(600)\n")
    t0 = time.time()
    rc = launch(_worker(code), num_processes=2, coordinator="localhost:0",
                heartbeat_timeout=2.0, poll_s=0.2)
    assert rc == 1
    assert time.time() - t0 < 60


def test_cli_render_mesh_under_launcher(tmp_path, capfd):
    """``render --mesh 2,1`` as two gloo ranks under the port's launcher
    writes one PNG (rank 0 alone prints and writes) within one uint8 level
    of ``--mesh 1,1``'s on every pixel."""
    from rtgs_tpu_torch.__main__ import main
    from rtgs_tpu_torch.scene import random_scene
    from rtgs_tpu_torch.utils.image import load_image

    ply = tmp_path / "s.ply"
    save_scene(ply, random_scene(200, extent=0.5, seed=3, device="cpu"))
    argv = ["render", "-o", str(ply), "-r", "48,32", "-d", "8",
            "--radius", "2.0", "--device", "cpu"]
    one = tmp_path / "one.png"
    main([*argv, "--output", str(one)])
    two = tmp_path / "two.png"
    cmd = [sys.executable, "-m", "rtgs_tpu_torch", *argv, "--mesh", "2,1",
           "--num-processes", "2", "--coordinator",
           f"file://{tmp_path}/store", "--output", str(two)]
    capfd.readouterr()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    assert launch(cmd, num_processes=2, coordinator="localhost:0",
                  env=env) == 0
    printed = capfd.readouterr().out
    assert printed.count("Rendered 48x32") == 1, printed
    a = np.round(load_image(one) * 255)
    b = np.round(load_image(two) * 255)
    assert a.shape == b.shape == (32, 48, 3)
    assert np.abs(a - b).max() <= 1
