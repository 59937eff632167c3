"""Command-line interface of the PyTorch/CUDA port.

  * ``render`` — render one frame from an orbit-camera pose to an image;
  * ``orbit``  — render a turntable sweep of N frames;
  * ``fit``    — optimize a scene against multiview targets (a
    ``transforms.json`` dataset, or orbit renders of the input scene);
  * ``bench``  — measure rays/s of the chosen renderer on the device.

Flags mirror ``python -m rtgs_tpu`` (``-o/--open``, ``-r/--res W,H``,
``-f/--fov``, ``-s/--sample``, ``-d/--depth``, ``--scale``, ...), plus
``--device`` (default ``cuda``): with no CUDA device the command fails
instead of running on the CPU; pass ``--device cpu`` for that. ``render``
and ``orbit`` run under ``torch.inference_mode()``; ``fit`` trains through
the fused-payload renderer (``--renderer keys|oracle|tiled`` through those).
``LOG_LEVEL`` sets logging.

    python -m rtgs_tpu_torch render -o scene.ply -r 1920,1088 -d 16
    python -m rtgs_tpu_torch fit -o scene.ply -r 512,384 --steps 500
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import pathlib
import sys
import time

import torch


def _setup_logging():
    level = os.getenv("LOG_LEVEL", "WARNING").upper()
    logging.basicConfig(level=getattr(logging, level, logging.INFO))


def _res(s: str):
    parts = s.split(",")
    if len(parts) != 2:
        raise argparse.ArgumentTypeError(
            f"--res wants W,H (e.g. 960,540), got {s!r}")
    return (int(parts[0]), int(parts[1]))


def _add_common_flags(p: argparse.ArgumentParser):
    p.add_argument("-o", "--open", type=pathlib.Path, required=True,
                   help="Path to the .ply Gaussian splatting scene file.")
    p.add_argument("-r", "--res", type=_res, default=(960, 540),
                   help="Render resolution W,H")
    p.add_argument("-f", "--fov", type=float, default=90.0,
                   help="Vertical FOV in degrees.")
    p.add_argument("-s", "--sample", type=int, default=1,
                   help="Samples to accumulate per frame (all identical "
                        "unless --jitter is set).")
    p.add_argument("--jitter", action="store_true",
                   help="Subpixel-jitter samples 2..N (needs -s > 1).")
    p.add_argument("-d", "--depth", type=int, default=16,
                   help="Render sample depth (composited layers).")
    p.add_argument("--scale", type=float, default=1.0,
                   help="Global Gaussian scale.")
    p.add_argument("--renderer",
                   choices=["auto", "oracle", "tiled", "pallas", "keys"],
                   default="auto",
                   help="render/orbit: auto and keys render the keys path, "
                        "pallas the fused-payload path, oracle brute force, "
                        "tiled the per-tile argmin peel. fit: auto and "
                        "pallas train through the fused-payload path, keys "
                        "through the keys path, oracle and tiled through "
                        "autograd.")
    p.add_argument("--max-candidates", type=int, default=None,
                   help="Per-tile candidate budget (default 512; raise "
                        "until the overflow counters read 0).")
    p.add_argument("--tile-bands", type=int, default=None,
                   help="Render the tile axis in N sequential bands "
                        "(bounds the winner-row gather memory).")
    p.add_argument("--bin-narrow", type=int, default=None,
                   help="Binning narrow-class fan-out width in tiles "
                        "(default 4).")
    p.add_argument("-v", "--bvh", type=int, default=1024,
                   help="BVH node budget (accepted for flag parity; the "
                        "tile-binned renderer needs no BVH).")
    p.add_argument("--radius", type=float, default=1.0,
                   help="Orbit camera radius.")
    p.add_argument("--theta", type=float, default=0.0)
    p.add_argument("--phi", type=float, default=None,
                   help="Orbit polar angle (default π/2).")
    p.add_argument("--device", type=str, default="cuda",
                   help="Torch device to render on (default cuda).")


def _device(args) -> torch.device:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: CUDA is not available; pass "
            "--device cpu to render on the CPU")
    return dev


def _load(args, device):
    from rtgs_tpu_torch.scene import load_scene

    return load_scene(args.open, scale=args.scale, device=device)


def _camera(args, theta, device):
    from rtgs_tpu_torch.camera import camera_from_fov
    from rtgs_tpu_torch.viewer.orbit import OrbitState

    state = OrbitState(theta=theta,
                       phi=math.pi / 2 if args.phi is None else args.phi,
                       r=args.radius)
    pos, rot = state.camera_pose()
    return camera_from_fov(pos, rot, args.res, args.fov, device=device)


def _render_kwargs(args) -> dict:
    kw = {}
    if args.max_candidates:
        kw["max_candidates"] = args.max_candidates
    if args.tile_bands:
        kw["tile_bands"] = args.tile_bands
    if args.bin_narrow:
        kw["bin_narrow"] = args.bin_narrow
    return kw


def _render(g, cam, args) -> torch.Tensor:
    from rtgs_tpu_torch.render.api import render, render_progressive

    kw = _render_kwargs(args)
    with torch.inference_mode():
        if args.sample > 1:
            return render_progressive(
                g, cam, depth=args.depth, samples=args.sample,
                renderer=args.renderer, jitter=args.jitter, **kw)
        return render(g, cam, depth=args.depth, renderer=args.renderer, **kw)


def _save(path, img: torch.Tensor) -> None:
    from rtgs_tpu_torch.camera import image_to_display
    from rtgs_tpu_torch.utils.image import save_image

    save_image(path, image_to_display(img).cpu().numpy())


def cmd_render(args):
    device = _device(args)
    g = _load(args, device)
    cam = _camera(args, args.theta, device)
    t0 = time.time()
    img = _render(g, cam, args).cpu()
    dt = time.time() - t0
    out = args.output or (args.open.stem + ".png")
    _save(out, img)
    w, h = args.res
    print(f"Rendered {w}x{h} ({g.num} splats, depth {args.depth}) "
          f"in {dt:.2f}s -> {out}")


def cmd_orbit(args):
    device = _device(args)
    g = _load(args, device)
    outdir = pathlib.Path(args.output or "orbit_frames")
    outdir.mkdir(parents=True, exist_ok=True)
    for i in range(args.frames):
        cam = _camera(args, args.theta + 2 * math.pi * i / args.frames,
                      device)
        _save(outdir / f"frame_{i:04d}.png", _render(g, cam, args))
    print(f"Rendered {args.frames} orbit frames -> {outdir}/")


def cmd_fit(args):
    """Optimize a scene against ``--data transforms.json`` targets, or,
    without ``--data``, against orbit renders of the input scene
    (self-supervised). ``--max-candidates``, ``--tile-bands`` and
    ``--bin-narrow`` reach both the target renders and the training
    renders."""
    import numpy as np

    from rtgs_tpu_torch.config import TrainConfig
    from rtgs_tpu_torch.scene import save_scene
    from rtgs_tpu_torch.train.datasets import (load_transforms_dataset,
                                               synthetic_orbit_dataset)
    from rtgs_tpu_torch.train.solver import (Solver, init_params,
                                             init_params_from_points,
                                             training_renderer)

    renderer = training_renderer(args.renderer)
    device = _device(args)
    g = _load(args, device)
    kw = _render_kwargs(args)
    if args.data:
        ds = load_transforms_dataset(args.data, downscale=args.downscale,
                                     device=device)
    else:
        ds = synthetic_orbit_dataset(
            g, args.views, args.res, fov=args.fov, radius=args.radius,
            depth=args.depth, renderer=renderer, **kw)

    if args.from_scratch:
        # Random subsample of the input means as the seed point cloud.
        idx = torch.from_numpy(np.random.default_rng(0).choice(
            g.num, size=min(args.init_points, g.num), replace=False))
        idx = idx.to(device)
        params = init_params_from_points(g.means[idx], colors=g.colors[idx])
        mask = torch.ones((params.means.shape[0],), device=device)
    else:
        params = init_params(g)
        mask = g.mask

    cfg = TrainConfig(iterations=args.steps,
                      checkpoint_dir=args.checkpoint_dir or "checkpoints",
                      checkpoint_every=args.checkpoint_every)
    solver = Solver(params=params, mask=mask, cfg=cfg,
                    cameras=list(ds.cameras), targets=list(ds.images),
                    depth=args.depth, renderer=renderer, render_kwargs=kw)
    metrics = solver.train(num_steps=args.steps)
    out = args.output or (args.open.stem + "_fit.ply")
    save_scene(out, solver.scene())
    print(f"fit {args.steps} steps: loss={metrics['loss']:.5f} "
          f"psnr={metrics['psnr']:.2f} live={solver.num_live} -> {out}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_seconds(fn, device: torch.device, iters: int) -> float:
    """Median host-clock seconds of ``fn()`` over ``iters`` calls, each
    ending in a device synchronize."""
    ts = []
    for _ in range(iters):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def cmd_bench(args):
    """Rays/s of one frame, in two passes after a warm-up frame: the
    compute rate (render, then synchronize; median of ``--iters``), and the
    frame with the whole image read to the host (what an interactive viewer
    pays per displayed frame; median of max(iters/2, 3))."""
    device = _device(args)
    g = _load(args, device)
    cam = _camera(args, args.theta, device)
    _render(g, cam, args).cpu()  # warm-up: builds the kernels at first use
    dt = _median_seconds(lambda: _render(g, cam, args), device, args.iters)
    d2 = _median_seconds(lambda: _render(g, cam, args).cpu(), device,
                         max(args.iters // 2, 3))
    rays = args.res[0] * args.res[1]
    print(f"{rays / dt / 1e6:.2f}M rays/s ({dt * 1e3:.1f} ms/frame compute, "
          f"{1.0 / dt:.1f} FPS; {d2 * 1e3:.1f} ms/frame with full image "
          f"readback, {1.0 / d2:.1f} FPS; {g.num} splats, depth "
          f"{args.depth})")


def main(argv=None):
    _setup_logging()
    parser = argparse.ArgumentParser(
        "rtgs-tpu-torch",
        description="Ray-traced 3D Gaussian splatting renderer "
                    "(PyTorch/CUDA port).")
    sub = parser.add_subparsers(dest="command", required=True)

    p_render = sub.add_parser("render", help="Render a single frame.")
    _add_common_flags(p_render)
    p_render.add_argument("--output", type=str, default=None)
    p_render.set_defaults(func=cmd_render)

    p_orbit = sub.add_parser("orbit", help="Render an orbit turntable.")
    _add_common_flags(p_orbit)
    p_orbit.add_argument("--frames", type=int, default=12)
    p_orbit.add_argument("--output", type=str, default=None)
    p_orbit.set_defaults(func=cmd_orbit)

    p_fit = sub.add_parser(
        "fit", help="Optimize a scene against multiview targets.")
    _add_common_flags(p_fit)
    p_fit.add_argument("--data", type=str, default=None,
                       help="transforms.json dataset; default: "
                            "self-supervised orbit renders of the scene.")
    p_fit.add_argument("--downscale", type=int, default=1)
    p_fit.add_argument("--views", type=int, default=24,
                       help="Orbit views for the self-supervised target set.")
    p_fit.add_argument("--steps", type=int, default=500)
    p_fit.add_argument("--from-scratch", action="store_true",
                       help="Re-initialize from a point subsample instead "
                            "of the loaded parameters.")
    p_fit.add_argument("--init-points", type=int, default=10_000)
    p_fit.add_argument("--checkpoint-dir", type=str, default=None)
    p_fit.add_argument("--checkpoint-every", type=int, default=0)
    p_fit.add_argument("--output", type=str, default=None)
    p_fit.set_defaults(func=cmd_fit)

    p_bench = sub.add_parser("bench", help="Measure rays/s.")
    _add_common_flags(p_bench)
    p_bench.add_argument("--iters", type=int, default=10)
    p_bench.set_defaults(func=cmd_bench)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
