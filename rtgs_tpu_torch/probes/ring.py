"""The ring renderer across processes: each mesh shape's frame against
``render_tiled_keys`` on every rank's own device; each mesh's scene
gradients against the single-device keys path's, bitwise; and with
``--train`` the sharded training step against the one-device step. One
process a mesh cell, so run it under the launcher with as many processes
as the meshes have cells:

    python -m rtgs_tpu_torch.parallel.launcher --num-processes 4 \\
        --coordinator localhost:29555 -- python -m rtgs_tpu_torch.probes.ring \\
        --train

The bench scene (``random_scene`` seed 0, extent 2.0, scales 0.005-0.03) and
pose (θ 0.4, φ 1.2, r 5, FOV 60°). Defaults: the 1M scene at 1920x1088,
budgets 3584 / 64 / narrow 4 (the reference render in 8 tile bands), meshes
4x1, 2x2 and 1x4. Gradients of Σ image² at 100k @ 512x384, budgets 1536 /
128, on every mesh: bitwise a second run and bitwise the single-device keys
path on each rank's shard rows (the owners sum in one card's order), with
the forward+backward and backward times, the bytes each rank's backward
hands to collectives for other ranks (counted at the ``torch.distributed``
calls; an all-reduce counts 2(n − 1)/n of its tensor, a ring's share) and
the peak. ``--train``: ``--steps`` sharded steps
(``train/solver.py:make_sharded_train_step``) on each mesh against as many
one-device ``make_train_step(renderer="keys")`` steps on the padded scene,
parameters, Adam moments and losses bitwise, each step's time both ways, at
the gradient configuration and at the JAX package's dry-run scale (100k @
256x256, depth 8; ``__graft_entry__.py:98-100``) with a candidate budget
of 2048, at which one device drops no pair (the dry run's 512 drops
77,871 there, pairs that a shard's own binning keeps, so its sharded step
renders another image than one device's).
Times are the host clock around a call ending in a synchronize, after a
barrier, median of 5 (3 for gradients); on the CPU (``--device cpu``,
gloo) they time the plain versions and are no device metric. Rank 0
prints.
"""

from __future__ import annotations

import argparse
import contextlib
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
# The candidate budget of --train's dry-run configuration: the JAX dry
# run's 512 drops 77,871 pairs on one device at 100k @ 256x256, 2048 none.
DRY_CANDIDATES = 2048


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


@contextlib.contextmanager
def counting_sends():
    """Count the bytes this rank hands to ``torch.distributed`` for other
    ranks inside the block, through the calls a ring's backward makes (this
    tree's and its parent's): a ``batch_isend_irecv``'s sends, an
    ``all_to_all_single``'s input less this rank's own block and 2(n − 1)/n
    of an ``all_reduce``'s tensor. Yields a one-entry list holding the
    count."""
    sent = [0]
    real = {f: getattr(dist, f) for f in ("batch_isend_irecv",
                                          "all_to_all_single", "all_reduce")}

    def nbytes(t):
        return t.numel() * t.element_size()

    def size(group):
        return dist.get_world_size(group)

    def batch_isend_irecv(ops):
        sent[0] += sum(nbytes(op.tensor) for op in ops
                       if op.op is real_isend)
        return real["batch_isend_irecv"](ops)

    def all_to_all_single(output, input, output_split_sizes=None,
                          input_split_sizes=None, group=None, **kw):
        per_row = nbytes(input) // max(input.shape[0], 1)
        if input_split_sizes is None:
            own = input.shape[0] // size(group)
        else:
            own = input_split_sizes[dist.get_rank(group)]
        sent[0] += nbytes(input) - own * per_row
        return real["all_to_all_single"](output, input, output_split_sizes,
                                         input_split_sizes, group=group, **kw)

    def all_reduce(tensor, *a, group=None, **kw):
        n = size(group)
        sent[0] += nbytes(tensor) * 2 * (n - 1) // n
        return real["all_reduce"](tensor, *a, group=group, **kw)

    real_isend = dist.isend
    patched = dict(batch_isend_irecv=batch_isend_irecv,
                   all_to_all_single=all_to_all_single,
                   all_reduce=all_reduce)
    for name, fn in patched.items():
        setattr(dist, name, fn)
    try:
        yield sent
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def _leaves(g):
    return {f: getattr(g, f).detach().clone().requires_grad_()
            for f in FIELDS}


def ring_gradient(g, cam, mesh, kw, device, reps=3):
    """Scene gradients of Σ image² through the ring, with the median
    forward+backward and backward ms, the bytes the backward sends and the
    peak. Returns (grads, fwd_bwd_ms, bwd_ms, sent, peak_gib)."""
    def once():
        leaves = _leaves(g)
        dist.barrier()
        _sync(device)
        t0 = time.perf_counter()
        img = render_tiled_sharded(
            shard_scene(type(g)(mask=g.mask, **leaves), mesh), cam, mesh,
            **kw)
        loss = (img ** 2).sum()
        _sync(device)
        t1 = time.perf_counter()
        with counting_sends() as sent:
            loss.backward()
        _sync(device)
        t2 = time.perf_counter()
        return ({f: x.grad for f, x in leaves.items()},
                (t2 - t0) * 1e3, (t2 - t1) * 1e3, sent[0])

    grads = once()[0]
    _reset_peak(device)
    runs = [once() for _ in range(reps)]
    differ = sum(not torch.equal(grads[f], runs[-1][0][f]) for f in FIELDS)
    if differ:
        raise RuntimeError(f"ring gradient: {differ} fields differ between "
                           "two runs")
    return (grads, statistics.median(r[1] for r in runs),
            statistics.median(r[2] for r in runs), runs[-1][3],
            _peak_gib(device))


def gradients(args, device, say):
    """Each mesh's scene gradients of Σ image², bitwise the single-device
    keys path's on every rank's shard rows, with their times and bytes."""
    g = random_scene(args.grad_n, extent=2.0, scale_range=(0.005, 0.03),
                     seed=0, device=device)
    cam = _camera(args.grad_res, device)
    kw = dict(depth=args.depth, max_candidates=args.grad_cand,
              max_global=128)
    ref_leaves = _leaves(g)
    ref = render_tiled_keys(type(g)(mask=g.mask, **ref_leaves), cam, **kw)
    (ref ** 2).sum().backward()
    w, h = args.grad_res
    for shape in args.grad_meshes:
        mesh = make_mesh(*shape, device=device)
        grads, ms, bwd_ms, sent, peak = ring_gradient(g, cam, mesh, kw,
                                                      device)
        m = -(-g.num // mesh.n_prims)
        lo = mesh.prims_rank * m
        parts, differ = [], 0
        for f in FIELDS:
            got = grads[f][lo:lo + m]
            want = ref_leaves[f].grad[lo:lo + m]
            differ += int(_max_over_ranks(not torch.equal(got, want),
                                          device))
            rel = ((got - want).abs()
                   / ref_leaves[f].grad.abs().max()).flatten()
            parts.append(f"{f} {_max_over_ranks(rel.max(), device):.1e}")
        say(f"ring {shape[0]}x{shape[1]} scene gradients of Σ image² at "
            f"{g.num} @ {w}x{h}: a second run bitwise the first on every "
            "rank; against render_tiled_keys on one device, on each rank's "
            "shard rows: "
            + ("bitwise equal in every field on every rank" if differ == 0
               else f"{differ} fields differ; max relative to the field's "
                    "largest, worst rank: " + "; ".join(parts))
            + f"; forward+backward {ms:.2f} ms, backward {bwd_ms:.2f} ms "
              f"(rank 0), slowest rank "
              f"{_max_over_ranks(ms, device):.2f} / "
              f"{_max_over_ranks(bwd_ms, device):.2f} ms; the backward "
              f"sends {sent} bytes (rank 0), at most "
              f"{int(_max_over_ranks(sent, device))} bytes a rank; peak "
              f"{_max_over_ranks(peak, device):.2f} GiB")


def step_comparison(g, cam, target, mesh, steps, depth, kw):
    """``steps`` sharded steps on this rank's shard of ``pad_scene(g,
    n_prims)`` against as many one-device keys steps on the whole padded
    scene, on this rank's device. Returns a dict: ``differ`` (the names
    of what is not bitwise equal: parameters, Adam moments, losses),
    ``ring_ms`` and ``one_ms`` (each step's host time with a synchronize),
    ``loss`` (the sharded losses) and ``ring_launches`` (the launches of
    the keys kernel and of ``segment_rows.cu`` in the sharded steps)."""
    from rtgs_tpu_torch.config import TrainConfig
    from rtgs_tpu_torch.ops import peel
    from rtgs_tpu_torch.scene import pad_scene
    from rtgs_tpu_torch.train.solver import (SceneParams, _leaf,
                                             init_params, make_optimizer,
                                             make_sharded_train_step,
                                             make_train_step, shard_params)

    cfg = TrainConfig()
    g = pad_scene(g, mesh.n_prims)
    raw = init_params(g)

    def run(params, mask, step):
        losses, ms = [], []
        for _ in range(steps):
            if dist.is_initialized():
                dist.barrier()
            _sync(cam.device)
            t0 = time.perf_counter()
            losses.append(step(params, mask, cam, target)["loss"])
            _sync(cam.device)
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, ms

    kernels = ("peel_keys_cuda", "segment_rows_cuda")
    before = {k: getattr(peel, k).launches for k in kernels}
    shard, mask = shard_params(raw, g.mask, mesh)
    opt = make_optimizer(cfg, shard)
    ring_losses, ring_ms = run(shard, mask, make_sharded_train_step(
        cfg, opt, mesh, depth=depth, **kw))
    launches = {k: getattr(peel, k).launches - before[k] for k in kernels}
    whole = SceneParams(*(_leaf(p) for p in raw))
    one_opt = make_optimizer(cfg, whole)
    one_losses, one_ms = run(whole, g.mask, make_train_step(
        cfg, one_opt, depth=depth, renderer="keys", **kw))
    m = g.num // mesh.n_prims
    lo = mesh.prims_rank * m
    differ = [f"loss {i}" for i, (a, b) in enumerate(zip(ring_losses,
                                                         one_losses))
              if not torch.equal(a, b)]
    for f, p, q in zip(SceneParams._fields, shard, whole):
        pairs = (("", p.detach(), q.detach()),
                 (" m", opt.state[p]["exp_avg"], one_opt.state[q]["exp_avg"]),
                 (" v", opt.state[p]["exp_avg_sq"],
                  one_opt.state[q]["exp_avg_sq"]))
        differ += [f + tag for tag, a, b in pairs
                   if not torch.equal(a, b[lo:lo + m])]
    return {"differ": differ, "ring_ms": ring_ms, "one_ms": one_ms,
            "loss": [float(x) for x in ring_losses],
            "ring_launches": launches}


def train(args, device, say):
    """``--steps`` sharded steps on every mesh against the one-device
    step, at the gradient configuration and at the dry-run scale. The
    contract holds where one device drops no pair: where it drops some, a
    shard's own binning keeps pairs the whole scene's drops, and the
    sharded step renders another image (reported, not held)."""
    configs = (
        (f"{args.grad_n} @ {args.grad_res[0]}x{args.grad_res[1]}, depth "
         f"{args.depth}", args.grad_n, args.grad_res, args.depth,
         dict(max_candidates=args.grad_cand, max_global=128)),
        (f"the dry run's scale, {args.dry_n} @ {args.dry_res[0]}x"
         f"{args.dry_res[1]}, depth 8", args.dry_n, args.dry_res, 8,
         dict(max_candidates=DRY_CANDIDATES, max_global=64)),
    )
    for label, n, res, depth, kw in configs:
        g = random_scene(n, extent=2.0, scale_range=(0.005, 0.03), seed=0,
                         device=device)
        cam = _camera(res, device)
        with torch.no_grad():
            _, stats = render_tiled_keys(g, cam, depth=depth,
                                         with_stats=True, **kw)
        dropped = int(stats["local_overflow"] + stats["global_overflow"])
        gen = torch.Generator(device="cpu").manual_seed(1)
        target = torch.rand(res + (3,), generator=gen).to(device)
        for shape in args.meshes:
            mesh = make_mesh(*shape, device=device)
            out = step_comparison(g, cam, target, mesh, args.steps, depth,
                                  kw)
            bad = int(_max_over_ranks(len(out["differ"]), device))
            ring_ms = [_max_over_ranks(x, device) for x in out["ring_ms"]]
            say(f"sharded step {shape[0]}x{shape[1]} at {label}, budgets "
                f"{kw['max_candidates']} / {kw['max_global']} (one device "
                f"drops {dropped} pairs): {args.steps} steps "
                + ("bitwise the one-device keys steps on every rank "
                   "(parameters, Adam moments, losses)" if bad == 0 else
                   f"differ from the one-device steps in {bad} items on "
                   f"some rank (rank 0: {', '.join(out['differ'][:8])})")
                + "; ms a step, sharded (slowest rank) / one device: "
                + ", ".join(f"{a:.2f} / {b:.2f}"
                            for a, b in zip(ring_ms, out["one_ms"]))
                + (f" (median after the first: "
                   f"{statistics.median(ring_ms[1:]):.2f} / "
                   f"{statistics.median(out['one_ms'][1:]):.2f})"
                   if args.steps > 1 else "")
                + "; loss " + ", ".join(f"{x:.6f}" for x in out["loss"]))


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
    ap.add_argument("--grad-meshes", type=lambda s: [_pair(m) for m in
                                                     s.split(",")],
                    default=[(4, 1), (2, 2), (1, 4)],
                    help="Mesh shapes whose gradients are held.")
    ap.add_argument("--grad-n", type=int, default=100_000)
    ap.add_argument("--grad-res", type=_pair, default=(512, 384))
    ap.add_argument("--grad-cand", type=int, default=1536)
    ap.add_argument("--train", action="store_true",
                    help="Also hold the sharded training step against the "
                         "one-device step on every mesh.")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--dry-n", type=int, default=100_000,
                    help="Splats of the dry-run configuration (--train).")
    ap.add_argument("--dry-res", type=_pair, default=(256, 256))
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
        if args.train:
            train(args, device, say)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
