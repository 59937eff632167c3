"""From-scratch fit with adaptive density control at production length
(port of ``scripts/fitscratch.py``): seed a sparse point cloud, grow it by
clone/split/prune over a long run, and record the PSNR curve, the step
time, every capacity growth and the count of capacities seen; then save
the fitted scene as a ``.ply`` and reload it as a round-trip check.

    python -m rtgs_tpu_torch.probes.fitscratch [--gt-n 100000]
        [--seed-points 10000] [--steps 1500] [--views 16] [--res 512,384]
        [--depth 16] [--cand 1536] [--renderer keys] [--densify-every 100]
        [--densify-grad-threshold 1.5e-4] [--max-live 150000] [--out PATH]
        [--device cuda]

Protocol, as the script's code runs it (its docstring says a structured
ground truth; its code draws ``random_scene``, and so does this): the
ground truth is ``random_scene(gt_n, extent 2.0, scale_range (0.005,
0.03), seed 0)``, its 16 orbit views at 512×384 (radius 5, FOV 60°) the
targets; the seed is ``seed_points`` of its means and colors chosen by
``np.random.default_rng(0).choice`` (the SfM-like seeding of ``fit
--from-scratch``), padded with dead slots (quaternion w 1, opacity logit
−10) to a multiple of 256; density control every ``densify_every`` steps
from step ``densify_every`` until ``steps − 200`` (the rest settles), no
opacity resets; densification stops once the live count reaches
``max_live``. The median step time counts only steady steps (no density
pass and no growth in that step, not the first two). ``--out`` defaults
to ``fitscratch.ply`` in the temporary directory. :func:`run` takes any
ground truth and the global list's budget (the script's 128).

On the uniform box, the seeds' isotropic scale (the median
nearest-neighbour distance of 512 seeds, ~0.30 at 10k of 100k) exceeds the
world-size prune (0.1 of the 90th percentile of |mean|, ~0.26), so the
first density pass prunes ~99% of them and nothing grows: the JAX
package's solver does the same since it gained that prune (fault F11).
The structured scene (``make_scene.structured_scene``, the scene the
script's docstring names) keeps its seeds and grows.

Where the script counts recompiles (one trace of its jitted step per
capacity), this counts ``capacities``, the capacities the run has seen:
torch compiles nothing here, but each growth is the same event. The last
line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from rtgs_tpu_torch.probes import _common

# Steps at the end of the run without density control.
SETTLE = 200


def seed_params(gt, seed_points: int, multiple: int = 256):
    """The SfM-like seed: ``seed_points`` of the ground truth's means and
    colors (``np.random.default_rng(0).choice``, without replacement),
    initialized by ``init_params_from_points`` and padded with dead slots
    to a multiple of ``multiple``. Returns (SceneParams, mask)."""
    from rtgs_tpu_torch.train.solver import init_params_from_points

    dev = gt.device
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.choice(gt.num, size=seed_points,
                                      replace=False)).to(dev)
    params = init_params_from_points(gt.means[idx].detach(),
                                     colors=gt.colors[idx].detach())
    cap0 = -(-seed_points // multiple) * multiple
    pad = cap0 - seed_points
    if pad:
        params = type(params)(*(torch.cat([x, x.new_zeros(
            (pad,) + tuple(x.shape[1:]))]) for x in params))
        params.quats[seed_points:, 3] = 1.0
        params.opacity_logits[seed_points:] = -10.0
    mask = (torch.arange(cap0, device=dev) < seed_points).to(torch.float32)
    return params, mask


def dropped_pairs(solver, cand: int, glob: int) -> int:
    """Pairs the binning drops on the frame the solver's next step renders
    (its scene now, its next view): local plus global overflow."""
    from rtgs_tpu_torch.render.binning import tile_candidates

    cam = solver.cameras[solver.step % len(solver.cameras)]
    with torch.no_grad():
        b = tile_candidates(solver.scene(), cam, max_candidates=cand,
                            max_global=glob)
        return int(b.local_overflow) + int(b.global_overflow)


def host_roundtrips(solver, iters: int = 5) -> dict:
    """Milliseconds of the solver's two host round trips at its current
    size, each on its own after a sync: the per-splat gradient norms every
    step reads back, and the copy of the parameters a density pass makes."""
    dev = solver.mask.device
    norms = torch.linalg.norm(solver.params.means.detach(), dim=-1)

    def clock(fn):
        ts = []
        for _ in range(iters):
            _common.sync(dev)
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return sorted(ts)[len(ts) // 2]

    return {"grad_norms_ms": clock(lambda: norms.cpu().numpy()),
            "host_params_ms": clock(solver._host_params)}


def run(gt, seed_points: int = 10_000, steps: int = 1500, views: int = 16,
        res=(512, 384), depth: int = 16, cand: int = 1536,
        renderer: str = "keys", densify_every: int = 100,
        threshold: float = 1.5e-4, max_live: int = 150_000,
        out: str | None = None, glob: int = 128,
        stop_at: int | None = None, count_dropped: bool = False,
        on_step=None, log=print) -> dict:
    """The protocol on the ground truth ``gt`` (on its device), its last
    ``SETTLE`` steps without density control. ``stop_at`` ends the run
    after that many steps of the same protocol (the configuration still
    says ``steps``); ``count_dropped`` bins each step's frame once more to sum
    the pairs the binning drops; ``on_step(solver, metrics)`` is called
    after every step. Returns the script's result and ``psnrs`` (every
    step's), ``growth_memory`` (on the card: allocated and peak GiB after
    each growth's step), ``dropped_pairs`` (or None), ``host_roundtrips``
    and ``solver``."""
    from rtgs_tpu_torch.config import TrainConfig
    from rtgs_tpu_torch.scene import load_scene, save_scene
    from rtgs_tpu_torch.train.datasets import synthetic_orbit_dataset
    from rtgs_tpu_torch.train.solver import Solver

    dev = gt.device
    out = out or os.path.join(tempfile.gettempdir(), "fitscratch.ply")
    render_kw = dict(max_candidates=cand, max_global=glob)
    t0 = time.time()
    ds = synthetic_orbit_dataset(gt, views, res, fov=60.0, radius=5.0,
                                 depth=depth, renderer=renderer, **render_kw)
    log(f"dataset: {views} GT views in {time.time() - t0:.1f}s")
    params, mask = seed_params(gt, seed_points)
    cfg = TrainConfig(
        iterations=steps,
        densify_from=densify_every,
        densify_until=steps - SETTLE,     # settle before the final eval
        densify_every=densify_every,
        densify_grad_threshold=threshold,
        opacity_reset_every=0,            # short-run recipe: no resets
        checkpoint_every=0,
    )
    solver = Solver(params=params, mask=mask, cfg=cfg,
                    cameras=list(ds.cameras), targets=list(ds.images),
                    depth=depth, renderer=renderer, render_kwargs=render_kw)

    growths = []          # (step, old_cap, new_cap)
    orig_grow = solver._grow

    def traced_grow(min_extra):
        old = solver.mask.shape[0]
        orig_grow(min_extra)
        growths.append((solver.step, old, solver.mask.shape[0]))
    solver._grow = traced_grow

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    psnr_curve = []       # (step, psnr, live)
    psnrs, step_times, growth_memory = [], [], []
    dropped = 0 if count_dropped else None
    t_fit0 = time.time()
    for i in range(steps if stop_at is None else min(stop_at, steps)):
        if count_dropped:
            dropped += dropped_pairs(solver, cand, glob)
        cap_before, n_growths = solver.mask.shape[0], len(growths)
        t0 = time.perf_counter()
        metrics = solver.train_step()
        _common.sync(dev)
        dt = time.perf_counter() - t0
        psnrs.append(metrics["psnr"])
        densified = (solver.step % cfg.densify_every == 0
                     and cfg.densify_from <= solver.step <= cfg.densify_until)
        if len(growths) > n_growths and dev.type == "cuda":
            growth_memory.append({
                "step": solver.step,
                "allocated_gib": torch.cuda.memory_allocated(dev) / 2**30,
                "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30})
        if solver.num_live >= max_live and cfg.densify_until > 0:
            cfg.densify_until = 0          # growth target reached
            log(f"step {solver.step}: live={solver.num_live} >= "
                f"{max_live}, densification stopped")
        if not densified and solver.mask.shape[0] == cap_before and i > 1:
            step_times.append(dt)
        if solver.step % 50 == 0 or solver.step == 1:
            psnr_curve.append((solver.step, round(metrics["psnr"], 2),
                               solver.num_live))
            log(f"step {solver.step}: loss={metrics['loss']:.5f} "
                f"psnr={metrics['psnr']:.2f} live={solver.num_live} "
                f"cap={solver.mask.shape[0]} {dt * 1e3:.0f}ms")
        if on_step is not None:
            on_step(solver, metrics)
    t_fit = time.time() - t_fit0

    med = float(np.median(step_times)) if step_times else float("nan")
    save_scene(out, solver.scene())
    reloaded = load_scene(out, device=dev)
    n_live = solver.num_live
    assert reloaded.num >= n_live, (reloaded.num, n_live)
    log(f"saved {out}: {reloaded.num} splats reload OK")
    return {
        "protocol": "from-scratch + densification",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "gt_n": gt.num, "seed_points": seed_points,
        "steps": len(psnrs), "views": views, "res": list(res),
        "renderer": renderer,
        "final_psnr": psnr_curve[-1][1] if psnr_curve else None,
        "final_live": n_live,
        "capacity_growths": growths, "capacities": 1 + len(growths),
        "median_step_ms": round(med * 1e3, 1),
        "total_fit_s": round(t_fit, 1),
        "psnr_curve": psnr_curve,
        "reloaded": reloaded.num,
        "peak_gib": _common.peak_gib(dev),
        "growth_memory": growth_memory,
        "dropped_pairs": dropped,
        "host_roundtrips": host_roundtrips(solver),
        "psnrs": psnrs,
        "solver": solver,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gt-n", type=int, default=100_000)
    ap.add_argument("--seed-points", type=int, default=10_000)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--res", type=str, default="512,384")
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--cand", type=int, default=1536)
    ap.add_argument("--renderer", type=str, default="keys")
    ap.add_argument("--densify-every", type=int, default=100)
    ap.add_argument("--densify-grad-threshold", type=float, default=1.5e-4)
    ap.add_argument("--max-live", type=int, default=150_000,
                    help="stop densifying once live reaches this")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    res = tuple(int(x) for x in args.res.split(","))
    from rtgs_tpu_torch.scene import random_scene

    dev = _common.device_of(args.device)
    print(f"device={dev} gt={args.gt_n} seed={args.seed_points} res={res} "
          f"views={args.views} steps={args.steps} "
          f"renderer={args.renderer}", flush=True)
    gt = random_scene(args.gt_n, device=dev, **_common.BENCH_SCENE)
    result = run(gt, args.seed_points, args.steps, args.views, res,
                 args.depth, args.cand, args.renderer, args.densify_every,
                 args.densify_grad_threshold, args.max_live, args.out,
                 log=lambda m: print(m, flush=True))
    for key in ("psnrs", "solver"):
        result.pop(key)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
