"""The recovery fit at production scale (port of ``scripts/fitbench.py``):
re-fit a perturbed scene against its own multiview renders for a few
hundred steps; the loss/PSNR curve and the median step time.

    python -m rtgs_tpu_torch.probes.fitbench [n] [--steps 300] [--views 12]
        [--res 512,384] [--depth 16] [--cand 1536] [--renderer keys]
        [--device cuda]

Protocol (self-supervised, no dataset): the ground truth is
``random_scene(n, extent 2.0, scale_range (0.005, 0.03), seed 0)``; its 12
orbit views at 512×384 (radius 5, FOV 60°) are the targets; the means
(σ 0.01), log-scales (σ 0.3) and color logits (σ 0.5) are perturbed and
``Solver`` re-fits them with ``densify_every=0, opacity_reset_every=0``.
PSNR rising back toward the unperturbed render is the correctness signal;
the median step time (host clock around ``train_step`` ending in a sync,
steps 3 onward) the performance number. A curve point every 25 steps.

One deliberate difference from the script: the noise is drawn from a
``torch.Generator`` seeded with 7 (standard normals on the CPU, in the
order means, log-scales, color logits), where the script draws it from
``jax.random`` keys split from ``PRNGKey(7)``; the draws differ, the
protocol does not. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from rtgs_tpu_torch.probes import _common

NOISE = (("means", 0.01), ("log_scales", 0.3), ("color_logits", 0.5))
NOISE_SEED = 7
MAX_GLOBAL = 128     # the script's global list budget


def noise(params) -> dict:
    """The perturbation's standard normals, one per field of ``NOISE``,
    drawn on the CPU from a ``torch.Generator`` seeded with ``NOISE_SEED``
    (so the same on every device), each shaped as its field."""
    gen = torch.Generator(device="cpu").manual_seed(NOISE_SEED)
    return {f: torch.randn(tuple(getattr(params, f).shape), generator=gen,
                           dtype=torch.float32) for f, _ in NOISE}


def perturb(params):
    """``params`` with ``σ · noise`` added to each field of ``NOISE``."""
    z = noise(params)
    return params._replace(**{
        f: getattr(params, f) + sigma * z[f].to(getattr(params, f).device)
        for f, sigma in NOISE})


def run(gt, steps: int = 300, views: int = 12, res=(512, 384),
        depth: int = 16, cand: int = 1536, renderer: str = "keys",
        log=print) -> dict:
    """The protocol on the ground truth ``gt`` (on its device); returns
    the script's result and ``psnrs`` (every step's), ``first_psnr`` and
    ``last_psnr`` (means over the first and the last ``views`` steps: each
    view once) and the peak device memory of the steps (GiB, the card
    only)."""
    from rtgs_tpu_torch.config import TrainConfig
    from rtgs_tpu_torch.train.datasets import synthetic_orbit_dataset
    from rtgs_tpu_torch.train.solver import Solver, init_params

    dev = gt.device
    render_kw = dict(max_candidates=cand, max_global=MAX_GLOBAL)
    t0 = time.time()
    ds = synthetic_orbit_dataset(gt, views, res, fov=60.0, radius=5.0,
                                 depth=depth, renderer=renderer, **render_kw)
    log(f"dataset: {views} views in {time.time() - t0:.1f}s")
    params = perturb(init_params(gt))
    cfg = TrainConfig(iterations=steps, densify_every=0,
                      opacity_reset_every=0)
    solver = Solver(params=params, mask=gt.mask, cfg=cfg,
                    cameras=list(ds.cameras), targets=list(ds.images),
                    depth=depth, renderer=renderer, render_kwargs=render_kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    curve, ts, psnrs = [], [], []
    t_fit0 = time.time()
    for s in range(steps):
        t0 = time.perf_counter()
        m = solver.train_step()
        _common.sync(dev)
        ts.append(time.perf_counter() - t0)
        psnrs.append(m["psnr"])
        if s % 25 == 0 or s == steps - 1:
            curve.append({"step": s, "loss": round(m["loss"], 5),
                          "psnr": round(m["psnr"], 2)})
            log(f"step {s:4d}: loss={m['loss']:.5f} psnr={m['psnr']:.2f} "
                f"({ts[-1] * 1e3:.0f} ms)")
    ts_sorted = sorted(ts[2:])
    med = ts_sorted[len(ts_sorted) // 2]
    return {
        "metric": "fit_step_time",
        "median_step_ms": round(med * 1e3, 1),
        "steps_per_s": round(1.0 / med, 2),
        "n": gt.num,
        "res": list(res),
        "views": views,
        "steps": steps,
        "renderer": renderer,
        "wall_s": round(time.time() - t_fit0, 1),
        "curve": curve,
        "first_psnr": sum(psnrs[:views]) / len(psnrs[:views]),
        "last_psnr": sum(psnrs[-views:]) / len(psnrs[-views:]),
        "peak_gib": _common.peak_gib(dev),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "psnrs": psnrs,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=100_000)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--views", type=int, default=12)
    ap.add_argument("--res", type=str, default="512,384")
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--cand", type=int, default=1536)
    ap.add_argument("--renderer", type=str, default="keys")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    res = tuple(int(x) for x in args.res.split(","))
    from rtgs_tpu_torch.scene import random_scene

    dev = _common.device_of(args.device)
    print(f"device={dev} n={args.n} res={res} views={args.views} "
          f"steps={args.steps} renderer={args.renderer}", flush=True)
    gt = random_scene(args.n, device=dev, **_common.BENCH_SCENE)
    out = run(gt, args.steps, args.views, res, args.depth, args.cand,
              args.renderer, log=lambda m: print(m, flush=True))
    out.pop("psnrs")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
