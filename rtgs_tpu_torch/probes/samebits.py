"""Hold one checkout's peel dispatchers against another's, bit for bit, at
depths that one kernel's list holds: what a change that must leave those
depths alone has to show.

    python rtgs_tpu_torch/probes/samebits.py --root DIR --dump FILE
        [--device cuda] [--iters 9] [--small]
    python rtgs_tpu_torch/probes/samebits.py --compare FILE FILE [FILE ...]

Run it as a file, not with ``-m``: ``--dump`` imports ``rtgs_tpu_torch``
from the checkout ``DIR`` (``.`` for this one), so the same script drives
an older checkout that does not have it. For each configuration of
:data:`CONFIGS` (the bench scene seen from the bench pose, as
``probes/_common.scene_tables`` bins it) at each depth of :data:`DEPTHS`,
the file holds:

* the inputs: packed table, candidates, chunk bounds, pixel features;
* ``peel_keys`` (t1, ids); ``peel_fused`` (radiance, transmittance) and the
  table gradient of seeded cotangents through autograd; ``peel_topk`` (its
  five outputs) and its table gradient;
* ``render_tiled_keys`` (unbanded) of the scene, and its scene gradients
  of Σ image² (the keys path's shade backward); three keys training steps
  (``make_train_step(renderer="keys")``, ``make_optimizer``) towards a
  seeded target: parameters, Adam moments and losses;
* the launches each call made of every kernel wrapper (a kernel's
  ``.launches`` count; 0 on the CPU, where the plain twins run);
* the median ms of each call, forward and forward with backward (CUDA
  events; on the CPU the host clock, which times the plain twins).

``--compare`` holds every later file against the first: each tensor and
each launch count must be equal, else it names them and exits 1; the
times are printed side by side. A parent-against-change run on the card,
in one call: unpack the parent (``git archive``) into a gitignored
directory, then dump parent, change, change, parent and compare the four.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

# (label, splats, width, height, candidate budget, global budget, narrow)
CONFIGS = (
    ("1M@256x192", 1_000_000, 256, 192, 3584, 128, 4),
    ("100k@512x384", 100_000, 512, 384, 1536, 128, None),
)
DEPTHS = (16, 64)
# A scene small enough for the plain twins on a CPU (``--small``).
SMALL = (("600@64x48", 600, 64, 48, 640, 64, None),)
KERNELS = ("peel_keys_cuda", "peel_fused_cuda", "peel_fused_bwd_cuda",
           "peel_topk_cuda", "peel_topk_bwd_cuda", "segment_rows_cuda")


def _launches(peel) -> dict:
    return {k: getattr(getattr(peel, k), "launches", 0) for k in KERNELS}


def _made(peel, before: dict) -> dict:
    return {k: n - before[k] for k, n in _launches(peel).items()}


def dump_config(cfg, depths, device, iters: int) -> dict:
    """Outputs, launches and times of the three dispatchers at one
    configuration (see the module's docstring)."""
    import torch

    from rtgs_tpu_torch.ops import peel
    from rtgs_tpu_torch.probes import _common

    label, n, w, h, cand, glob, narrow = cfg
    packed, cands, lb, pix, _ = _common.scene_tables(n, w, h, cand, glob,
                                                     narrow, device)
    counts = peel._counts(cands)
    out = {f"{label}/in/{k}": v for k, v in
           (("packed", packed), ("candidates", cands), ("chunk_lb", lb),
            ("pix", pix))}
    launches, times = {}, {}
    for depth in depths:
        key = f"{label}/d{depth}"
        gen = torch.Generator(device=device).manual_seed(depth)
        t, p = cands.shape[0], pix.shape[1]
        g_rad = torch.randn((t, 3, p), generator=gen, device=device)
        g_tr = torch.randn((t, p), generator=gen, device=device)
        g_top = [torch.randn((t, p, depth), generator=gen, device=device)
                 for _ in range(5)]

        def keys():
            with torch.no_grad():
                return peel.peel_keys(packed, cands, pix, depth,
                                      chunk_lb=lb, counts=counts)

        def fused(backward):
            leaf = packed.detach().clone().requires_grad_(backward)
            rad, tr = peel.peel_fused(leaf, cands, pix, depth)
            if backward:
                torch.autograd.backward((rad, tr), (g_rad, g_tr))
            return rad, tr, leaf.grad

        def topk(backward):
            leaf = packed.detach().clone().requires_grad_(backward)
            lay = peel.peel_topk(leaf, cands, pix, depth)
            if backward:
                torch.autograd.backward(lay, g_top)
            return (*lay, leaf.grad)

        calls = {
            "keys": (keys, ("t1", "sid")),
            "fused": (lambda: fused(True), ("rad", "trans", "grad")),
            "topk": (lambda: topk(True),
                     ("t1", "alpha", "r", "g", "b", "grad")),
        }
        for name, (fn, fields) in calls.items():
            before = _launches(peel)
            res = fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            launches[f"{key}/{name}"] = _made(peel, before)
            for f, x in zip(fields, res):
                out[f"{key}/{name}/{f}"] = x.detach().cpu()
        times[f"{key}/keys"] = _common.median_ms(keys, iters, device)[0]
        for name, fn in (("fused", fused), ("topk", topk)):
            times[f"{key}/{name} fwd"] = _common.median_ms(
                lambda: fn(False), iters, device)[0]
            times[f"{key}/{name} fwd+bwd"] = _common.median_ms(
                lambda: fn(True), iters, device)[0]
    return dict(tensors={k: v.cpu() for k, v in out.items()},
                launches=launches, times=times)


STEPS = 3
SCENE_FIELDS = ("means", "quats", "scales", "colors", "opacities", "sh")


def dump_paths(cfg, depths, device) -> dict:
    """The keys render, its scene gradients and three keys training steps
    at one configuration (see the module's docstring)."""
    import numpy as np
    import torch

    from rtgs_tpu_torch.camera import camera_from_fov
    from rtgs_tpu_torch.config import TrainConfig
    from rtgs_tpu_torch.ops import peel
    from rtgs_tpu_torch.render.tiled import render_tiled_keys
    from rtgs_tpu_torch.scene import random_scene
    from rtgs_tpu_torch.train import solver
    from rtgs_tpu_torch.viewer.orbit import orbit_camera_pose

    label, n, w, h, cand, glob, narrow = cfg
    g = random_scene(n, extent=2.0, scale_range=(0.005, 0.03), seed=0,
                     device=device)
    pos, rot, _, _ = orbit_camera_pose(0.4, 1.2, 5.0, np.zeros(3),
                                       np.array([0.0, 0.0, 0.0, 1.0]))
    cam = camera_from_fov(pos, rot, (w, h), 60.0, device=device)
    kw = dict(max_candidates=cand, max_global=glob, bin_narrow=narrow)
    gen = torch.Generator(device="cpu").manual_seed(1)
    target = torch.rand((w, h, 3), generator=gen).to(device)
    out, launches = {}, {}
    for depth in depths:
        key = f"{label}/d{depth}"
        before = _launches(peel)
        leaves = {f: getattr(g, f).detach().clone().requires_grad_()
                  for f in SCENE_FIELDS}
        img = render_tiled_keys(type(g)(mask=g.mask, **leaves), cam,
                                depth=depth, **kw)
        (img ** 2).sum().backward()
        launches[f"{key}/render"] = _made(peel, before)
        out[f"{key}/render/image"] = img.detach()
        for f, x in leaves.items():
            out[f"{key}/render/grad_{f}"] = x.grad

        before = _launches(peel)
        params = solver.SceneParams(*(
            p.detach().clone().requires_grad_()
            for p in solver.init_params(g)))
        opt = solver.make_optimizer(TrainConfig(), params)
        step = solver.make_train_step(TrainConfig(), opt, depth=depth,
                                      renderer="keys", **kw)
        for i in range(STEPS):
            out[f"{key}/steps/loss{i}"] = step(params, g.mask, cam,
                                               target)["loss"]
        launches[f"{key}/steps"] = _made(peel, before)
        for f, p in zip(solver.SceneParams._fields, params):
            out[f"{key}/steps/{f}"] = p.detach()
            out[f"{key}/steps/m_{f}"] = opt.state[p]["exp_avg"]
            out[f"{key}/steps/v_{f}"] = opt.state[p]["exp_avg_sq"]
    return dict(tensors={k: v.detach().cpu() for k, v in out.items()},
                launches=launches, times={})


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def dump(path, device, configs=CONFIGS, depths=DEPTHS, iters=9) -> dict:
    """Run every configuration and save the result at ``path``."""
    import torch

    res = dict(tensors={}, launches={}, times={}, card=card_line(device))
    for cfg in configs:
        for part in (dump_config(cfg, depths, device, iters),
                     dump_paths(cfg, depths, device)):
            for k in ("tensors", "launches", "times"):
                res[k].update(part[k])
    torch.save(res, path)
    return res


def compare(paths) -> list[str]:
    """Every later file against the first; returns what differs."""
    import torch

    ref, *rest = [torch.load(p, weights_only=True) for p in paths]
    bad = []
    for p, other in zip(paths[1:], rest):
        if other["tensors"].keys() != ref["tensors"].keys():
            bad.append(f"{p}: other outputs")
        for k, v in ref["tensors"].items():
            w = other["tensors"].get(k)
            if w is None or w.dtype != v.dtype or not torch.equal(w, v):
                bad.append(f"{p}: {k}")
        if other["launches"] != ref["launches"]:
            bad.append(f"{p}: launches {other['launches']} against "
                       f"{ref['launches']}")
    return bad


def print_times(paths) -> None:
    import torch

    runs = [torch.load(p, weights_only=True) for p in paths]
    print(" | ".join(f"{pathlib.Path(p).name}: {r['card']}"
                     for p, r in zip(paths, runs)))
    for key in runs[0]["times"]:
        ms = (r["times"].get(key, float("nan")) for r in runs)
        print(f"{key:34s}" + "".join(f"{m:10.4f}" for m in ms) + "  ms")
    first = runs[0]
    for key, made in first["launches"].items():
        print(f"{key:34s} launches "
              + ", ".join(f"{k} {v}" for k, v in made.items() if v))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=pathlib.Path, default=pathlib.Path("."))
    ap.add_argument("--dump", type=pathlib.Path)
    ap.add_argument("--compare", type=pathlib.Path, nargs="+")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=9)
    ap.add_argument("--small", action="store_true",
                    help="the SMALL scene instead of CONFIGS")
    args = ap.parse_args(argv)
    if args.dump:
        root = args.root.resolve()
        sys.path.insert(0, str(root))
        import rtgs_tpu_torch
        from rtgs_tpu_torch.probes._common import device_of

        pkg = pathlib.Path(rtgs_tpu_torch.__file__).resolve().parent
        if pkg.parent != root:
            raise SystemExit(f"--root {root}: rtgs_tpu_torch was already "
                             f"imported from {pkg.parent}")
        dump(args.dump, device_of(args.device),
             configs=SMALL if args.small else CONFIGS, iters=args.iters)
        print(f"wrote {args.dump} from {pkg}")
    if args.compare:
        print_times(args.compare)
        bad = compare(args.compare)
        for b in bad:
            print(f"differs: {b}")
        if bad:
            return 1
        print(f"bitwise equal: {len(args.compare)} files, every output and "
              f"launch count")
    return 0


if __name__ == "__main__":
    sys.exit(main())
