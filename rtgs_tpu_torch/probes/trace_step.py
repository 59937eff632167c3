"""A profiler trace of training steps (port of ``scripts/trace_step.py``):
a Chrome trace of a few steps and a summary of where their device time
goes, so that the step's composition (binning, kernels, backward,
optimizer) can be read offline.

    python -m rtgs_tpu_torch.probes.trace_step [n] [steps] [outdir]
        [--device cuda]

The scene is ``random_scene(n, extent 2.0, scale_range (0.005, 0.03),
seed 0)`` (default 100k), its 4 orbit views at 256×256 (radius 5, FOV 60°)
the targets, depth 8, ``renderer="pallas"``, ``TrainConfig()``. One warm
step runs outside the trace window; then ``steps`` (default 3) run inside
``utils.profiling.trace``, which writes ``trace.json`` to ``outdir``
(default ``rtgs_torch_trace`` in the temporary directory). Printed: ms a
step (host clock, the trace on), the trace's file count and size, and the
device time summed by kernel group (:data:`GROUPS`; the rest under
``other``). On the CPU the trace holds no device kernels and the summary
is empty.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import torch

from rtgs_tpu_torch.probes import _common

DEPTH = 8           # the script's depth
# Kernel groups of a step's device time: a kernel joins the first group
# one of whose name fragments its name contains.
GROUPS = (
    ("peel_fwd", ("peel_fwd_kernel",)),
    ("peel_bwd", ("peel_bwd_kernel",)),
    ("segment_rows", ("hist_kernel", "scan_kernel", "place_kernel",
                      "short_kernel", "long_kernel")),
    ("sort", ("RadixSort", "radix_sort", "SortKernel", "sort")),
    ("adam", ("multi_tensor_apply", "Adam", "adam")),
)


def kernel_summary(trace_path) -> dict:
    """Device time (µs) and kernel count of a Chrome trace by group of
    :data:`GROUPS`, ``other`` for the rest."""
    events = json.loads(open(trace_path).read())["traceEvents"]
    out = {name: {"us": 0.0, "kernels": 0} for name, _ in GROUPS}
    out["other"] = {"us": 0.0, "kernels": 0}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name = e.get("name", "")
        group = next((g for g, frags in GROUPS
                      if any(f in name for f in frags)), "other")
        out[group]["us"] += float(e.get("dur", 0.0))
        out[group]["kernels"] += 1
    return out


def run(n: int = 100_000, steps: int = 3, outdir: str | None = None,
        device="cuda", views: int = 4, res=(256, 256), log=print) -> dict:
    """The protocol of the module docstring; returns ms a step, the
    trace's directory, file count and bytes, and :func:`kernel_summary`."""
    from rtgs_tpu_torch.config import TrainConfig
    from rtgs_tpu_torch.scene import random_scene
    from rtgs_tpu_torch.train.datasets import synthetic_orbit_dataset
    from rtgs_tpu_torch.train.solver import Solver, init_params
    from rtgs_tpu_torch.utils.profiling import trace

    dev = _common.device_of(str(device))
    g = random_scene(n, device=dev, **_common.BENCH_SCENE)
    ds = synthetic_orbit_dataset(g, views, res, fov=60.0, radius=5.0,
                                 depth=DEPTH, renderer="pallas")
    solver = Solver(params=init_params(g), mask=g.mask, cfg=TrainConfig(),
                    cameras=ds.cameras, targets=ds.images, depth=DEPTH,
                    renderer="pallas")
    t0 = time.time()
    m = solver.train_step()
    log(f"warm step: {time.time() - t0:.1f}s  loss={m['loss']:.4f}")
    with trace(outdir) as logdir:
        t0 = time.time()
        for _ in range(steps):
            m = solver.train_step()
        _common.sync(dev)
        dt = (time.time() - t0) / steps
    log(f"traced {steps} steps: {dt * 1e3:.1f} ms/step  "
        f"loss={m['loss']:.4f}  psnr={m.get('psnr', float('nan')):.2f}")
    files = [f for f in glob.glob(os.path.join(logdir, "**", "*"),
                                  recursive=True) if os.path.isfile(f)]
    total = sum(os.path.getsize(f) for f in files)
    log(f"trace: {len(files)} files, {total / 1e6:.1f} MB in {logdir}")
    summary = kernel_summary(os.path.join(logdir, "trace.json"))
    for name, s in summary.items():
        log(f"  {name:13s} {s['us'] / steps / 1e3:8.3f} ms a step in "
            f"{s['kernels'] / steps:.0f} kernels")
    return {"n": n, "steps": steps, "ms_per_step": dt * 1e3,
            "logdir": logdir, "files": len(files), "bytes": total,
            "kernels": summary}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=100_000)
    ap.add_argument("steps", type=int, nargs="?", default=3)
    ap.add_argument("outdir", nargs="?", default=None)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.n, args.steps, args.outdir, args.device,
                         log=lambda m: print(m, flush=True))))


if __name__ == "__main__":
    main()
