"""The ring renderer across processes: each mesh shape's frame against
``render_tiled_keys`` on every rank's own device, and the scene gradients of
one mesh against the single-device keys path. One process a mesh cell, so
run it under the launcher with as many processes as the meshes have cells:

    python -m rtgs_tpu_torch.parallel.launcher --num-processes 4 \\
        --coordinator localhost:29555 -- python -m rtgs_tpu_torch.probes.ring

The bench scene (``random_scene`` seed 0, extent 2.0, scales 0.005-0.03) and
pose (θ 0.4, φ 1.2, r 5, FOV 60°). Defaults: the 1M scene at 1920x1088,
budgets 3584 / 64 / narrow 4 (the reference render in 8 tile bands), meshes
4x1, 2x2 and 1x4; gradients of Σ image² on the 2x2 mesh at 100k @ 512x384,
budgets 1536 / 128, both paths with torch's deterministic algorithms.
Frame times are the host clock around a call ending in a synchronize, after
a barrier, median of 5; on the CPU (``--device cpu``, gloo) they time the
plain versions and are no device metric. Rank 0 prints.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from rtgs_tpu_torch.camera import camera_from_fov
from rtgs_tpu_torch.ops.peel import peel_keys_cuda
from rtgs_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from rtgs_tpu_torch.parallel.render import render_tiled_sharded, shard_scene
from rtgs_tpu_torch.render.tiled import render_tiled_keys
from rtgs_tpu_torch.scene import random_scene
from rtgs_tpu_torch.viewer.orbit import orbit_camera_pose

FIELDS = ("means", "quats", "scales", "colors", "opacities", "sh")


def _pair(s: str):
    a, b = s.lower().replace("x", ",").split(",")
    return int(a), int(b)


def _camera(res, device):
    pos, rot, _, _ = orbit_camera_pose(0.4, 1.2, 5.0, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    return camera_from_fov(pos, rot, res, 60.0, device=device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _frame_ms(fn, device, reps=5):
    fn()
    ts = []
    for _ in range(reps):
        dist.barrier()
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def _max_over_ranks(x: float, device) -> float:
    t = torch.tensor([float(x)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def _peak_gib(device) -> float:
    if device.type != "cuda":
        return float("nan")
    return torch.cuda.max_memory_allocated(device) / 2**30


def _reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def frames(args, device, say):
    """Each mesh's frame against the single-device keys render."""
    g = random_scene(args.n, extent=2.0, scale_range=(0.005, 0.03), seed=0,
                     device=device)
    cam = _camera(args.res, device)
    kw = dict(depth=args.depth, max_candidates=args.cand,
              max_global=args.glob, bin_narrow=args.narrow)
    with torch.inference_mode():
        ref, stats = render_tiled_keys(g, cam, tile_bands=args.bands,
                                       with_stats=True, **kw)
        ref_ms = _frame_ms(lambda: render_tiled_keys(
            g, cam, tile_bands=args.bands, **kw), device)
    dropped = int(stats["local_overflow"] + stats["global_overflow"])
    w, h = args.res
    say(f"render_tiled_keys {g.num} splats @ {w}x{h}, {args.bands} bands, "
        f"one device: {ref_ms:.2f} ms (rank 0); {dropped} candidates "
        f"dropped (a shard's binning drops fewer, so a frame that drops "
        f"any is no reference)")
    for shape in args.meshes:
        mesh = make_mesh(*shape, device=device)
        shard = shard_scene(g, mesh)
        with torch.inference_mode():
            peel_keys_cuda.launches = 0
            img = render_tiled_sharded(shard, cam, mesh, **kw)
            _sync(device)
            launches = peel_keys_cuda.launches
            err = _max_over_ranks((img - ref).abs().max(), device)
            _reset_peak(device)
            ms = _frame_ms(lambda: render_tiled_sharded(shard, cam, mesh,
                                                        **kw), device)
            peak = _max_over_ranks(_peak_gib(device), device)
        say(f"ring {shape[0]}x{shape[1]}: max |ring − keys| {err:.1e} over "
            f"all ranks; frame {ms:.2f} ms (rank 0), slowest rank "
            f"{_max_over_ranks(ms, device):.2f} ms; peak {peak:.2f} GiB; "
            f"keys launches {launches} (rank 0; the card's only)")


def gradients(args, device, say):
    """The scene gradients of Σ image² on one mesh against the single-device
    keys path, per rank on its shard's rows."""
    mesh = make_mesh(*args.grad_mesh, device=device)
    g = random_scene(args.grad_n, extent=2.0, scale_range=(0.005, 0.03),
                     seed=0, device=device)
    cam = _camera(args.grad_res, device)
    kw = dict(depth=args.depth, max_candidates=args.grad_cand,
              max_global=128)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        leaves = {f: getattr(g, f).detach().clone().requires_grad_()
                  for f in FIELDS}
        img = render_tiled_sharded(
            shard_scene(type(g)(mask=g.mask, **leaves), mesh), cam, mesh,
            **kw)
        (img ** 2).sum().backward()
        ref_leaves = {f: getattr(g, f).detach().clone().requires_grad_()
                      for f in FIELDS}
        ref = render_tiled_keys(type(g)(mask=g.mask, **ref_leaves), cam,
                                **kw)
        (ref ** 2).sum().backward()
    finally:
        torch.use_deterministic_algorithms(False)
    m = -(-g.num // mesh.n_prims)
    lo = mesh.prims_rank * m
    parts = []
    for f in FIELDS:
        got = leaves[f].grad[lo:lo + m]
        want = ref_leaves[f].grad[lo:lo + m]
        rel = ((got - want).abs() / ref_leaves[f].grad.abs().max()).flatten()
        q99 = float(rel.kthvalue(max(1, round(0.99 * rel.numel()))).values)
        bad = int((~torch.isfinite(got)).sum())
        parts.append(f"{f} q99 {_max_over_ranks(q99, device):.1e} max "
                     f"{_max_over_ranks(rel.max(), device):.1e}"
                     + (" NaN" if _max_over_ranks(bad, device) else ""))
    w, h = args.grad_res
    say(f"ring {args.grad_mesh[0]}x{args.grad_mesh[1]} scene gradients of "
        f"Σ image² at {g.num} @ {w}x{h} against render_tiled_keys on one "
        f"device (deterministic algorithms), on each rank's shard rows, "
        f"relative to the field's largest, worst rank: " + "; ".join(parts))


def main(argv=None):
    ap = argparse.ArgumentParser(
        "ring", description="The ring renderer across processes.")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--init", default=None,
                    help="Init URL or host:port of the rendezvous (default: "
                         "the launcher's MASTER_ADDR/MASTER_PORT).")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--res", type=_pair, default=(1920, 1088))
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--cand", type=int, default=3584)
    ap.add_argument("--glob", type=int, default=64)
    ap.add_argument("--narrow", type=int, default=4)
    ap.add_argument("--bands", type=int, default=8)
    ap.add_argument("--meshes", type=lambda s: [_pair(m) for m in
                                                s.split(",")],
                    default=[(4, 1), (2, 2), (1, 4)],
                    help="Mesh shapes rays x prims, e.g. 4x1,2x2,1x4.")
    ap.add_argument("--grad-mesh", type=_pair, default=(2, 2))
    ap.add_argument("--grad-n", type=int, default=100_000)
    ap.add_argument("--grad-res", type=_pair, default=(512, 384))
    ap.add_argument("--grad-cand", type=int, default=1536)
    args = ap.parse_args(argv)

    initialize_distributed(args.init, device=args.device)
    try:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.device(args.device).type == "cuda"
                  else torch.device(args.device))
        if device.type == "cpu":
            torch.set_num_threads(1)
        rank = dist.get_rank()

        def say(msg):
            if rank == 0:
                print(msg, flush=True)

        if device.type == "cuda":
            from rtgs_tpu_torch.ops import _build

            if rank == 0:
                import subprocess

                smi = subprocess.run(
                    ["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"], capture_output=True,
                    text=True, timeout=60).stdout.strip().splitlines()
                say(f"{dist.get_world_size()} ranks, one card each: "
                    + " | ".join(smi))
            if rank == 0:            # one build; the others load it
                _build.build()
            dist.barrier()
        frames(args, device, say)
        gradients(args, device, say)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
