"""The readings that the limits of ``correct`` are set between: the control
(the reference in the next precision down, put in the program's place) and
the faults a cell can have, planted in the program, each judged as a run
judges the program.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \
        --what control,altered [--seconds 2]

``--what``: ``program`` (the program as a run drives it: the sound
readings, many seeds in one process), ``control``; for a render cell
``altered`` (one tile of every frame brightened where the frame is
assembled) and ``half_depth`` (each frame selects and composites half its
layers: at depth 128 the first pass of the peel alone); for the fit cell
``half_batch`` (the loss over half the image's rows, the mean taken over
them) and ``unchanged`` (the optimizer's step leaves the parameters as they
are). Prints one JSON line a seed and reading. Not part of a benchmark run:
the runs never plant a fault.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from benchmark import run as H

FAULTS = {"orbit_render": ("altered", "half_depth"),
          "refit": ("half_batch", "unchanged")}


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted in it (as it is, for
    ``program``), for the block."""
    import torch

    if fault == "program":
        yield
        return
    if fault == "altered":
        import rtgs_tpu_torch.render.tiled as mod
        name = "_tiles_to_image"
        orig = getattr(mod, name)

        def broken(rad, ntx, nty, tile):
            img = orig(rad, ntx, nty, tile).clone()
            img[:16, :16] += 0.1
            return img
    elif fault == "half_depth":
        import rtgs_tpu_torch.ops.peel as mod
        name = "pass_depths"
        orig = getattr(mod, name)

        def broken(depth):
            return orig(max(1, depth // 2))
    elif fault == "half_batch":
        import rtgs_tpu_torch.train.solver as mod
        name = "render_loss"
        orig = getattr(mod, name)

        def broken(img, target, lam=0.2):
            h = img.shape[1] // 2
            return orig(img[:, :h], target[:, :h], lam)
    elif fault == "unchanged":
        mod, name = torch.optim.Adam, "step"
        orig = getattr(mod, name)

        def broken(self, closure=None):
            return None
    else:
        raise ValueError(f"unknown fault {fault!r}")
    setattr(mod, name, broken)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def reading(cell: dict, seed: int, what: str, seconds: float, device):
    """The checks of one run of ``cell`` with ``what`` in the program's
    place (``control``) or planted in it (a fault)."""
    if what == "control":
        return H.workload(cell, seed, device).control()
    with planted(what):
        out = H.run_cell(cell, seed, seconds, False, device)
    return {k: c["value"] for k, c in out["checks"].items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="control")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cell = H.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for what in args.what.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            vals = reading(cell, seed, what, args.seconds, dev)
            print(json.dumps({"workload": args.workload, "what": what,
                              "seed": seed, **vals}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
