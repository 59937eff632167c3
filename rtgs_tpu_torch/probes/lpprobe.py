"""The keys kernel in its forms, and the floor of its launch shape (port of
``scripts/lpprobe.py``).

    python -m rtgs_tpu_torch.probes.lpprobe [n] [w] [h] [--depth 16]
        [--cand 1536] [--glob 128] [--narrow 3] [--iters 7] [--device cuda]

(a) The TPU probe times its keys kernel over two axes, lane layout pk|lp ×
merge fori|unroll. Both are one kernel on Hopper (``ops/csrc/keys.cu``:
the list is in registers and the merge is an unrolled insertion), so this
probe times :func:`~rtgs_tpu_torch.ops.peel.peel_keys_cuda` in its output
layouts — (T, K, P) as the kernel writes it, and (T, P, K) made contiguous
for a pixel-major consumer — each with the early exit (``chunk_lb``) and
without it (zeros), and checks that all four agree bitwise.

(b) The floor kernels (``ops/csrc/probe_floor.cu``), output (T, 2K, P) f32
as the kernel's (t1, id) pair: ``nothing`` writes +inf; ``touch`` writes,
per tile, the sum over the tile's candidate rows of feature lane 0 (a −1
slot reads the sentinel row N). Each at T, T/4 and T/16 tiles, to separate
the per-tile cost from the launch.

One line per measurement: label, milliseconds (CUDA events, median of
``--iters``), the minimum.
"""

from __future__ import annotations

import argparse
import math

import torch

from rtgs_tpu_torch.ops.peel import F_DIM, _counts, _safe_ids, peel_keys
from rtgs_tpu_torch.probes import _common

FLOOR_VARIANTS = ("nothing", "touch")


def floor_torch(name: str, packed, candidates, p: int, depth: int):
    """The plain torch version of floor variant ``name``: (T, 2K, P)."""
    if name not in FLOOR_VARIANTS:
        raise ValueError(f"unknown floor variant {name!r}")
    t = candidates.shape[0]
    if name == "nothing":
        return torch.full((t, 2 * depth, p), math.inf, dtype=torch.float32,
                          device=packed.device)
    s = packed[:, 0][_safe_ids(packed, candidates)].sum(dim=1)   # (T,)
    return s[:, None, None].expand(t, 2 * depth, p).contiguous()


def floor_cuda(name: str, packed, candidates, p: int, depth: int):
    """Launch floor variant ``name`` of ``probe_floor.cu`` on the current
    stream. packed (N+1, 64) f32 and candidates (T, C) i32, contiguous CUDA
    tensors. Raises on a wrong input or a failed launch;
    ``floor_cuda.launches`` counts the launches."""
    if name not in FLOOR_VARIANTS:
        raise ValueError(f"unknown floor variant {name!r}")
    t, c = candidates.shape
    dev = _common.check_cuda(f"lpprobe {name}", [
        ("packed", packed, torch.float32, (packed.shape[0], F_DIM)),
        ("candidates", candidates, torch.int32, (t, c))])
    if p < 1 or depth < 1:
        raise ValueError(f"lpprobe {name}: P={p} and depth={depth} must be "
                         "positive")
    out = torch.empty((t, 2 * depth, p), dtype=torch.float32, device=dev)
    if t == 0:
        return out
    idx, stream = _common.launch_args(dev)
    err = _common.library().rtgs_probe_floor(
        FLOOR_VARIANTS.index(name), _common.ptr(packed),
        _common.ptr(candidates), _common.ptr(out), t, c, p, 2 * depth,
        packed.shape[0] - 1, idx, stream)
    _common.raise_on(err, f"lpprobe {name}")
    floor_cuda.launches += 1
    return out


floor_cuda.launches = 0


def floor(name: str, packed, candidates, p: int, depth: int):
    """Floor variant ``name``: the kernel for CUDA tensors (or an error),
    the plain version for CPU tensors."""
    if packed.device.type == "cpu":
        return floor_torch(name, packed, candidates, p, depth)
    return floor_cuda(name, packed, candidates, p, depth)


def keys_forms(packed, candidates, chunk_lb, pix, depth: int):
    """The keys stage in its four forms, label → a function returning
    (t1, sid): layouts ``kp`` (T, K, P) and ``pk`` (T, P, K), each with
    ``chunk_lb`` and with the early exit disabled. On CPU tensors
    :func:`~rtgs_tpu_torch.ops.peel.peel_keys` runs the plain twin, which
    ignores ``chunk_lb``."""
    def run(lb, layout):
        t1, sid = peel_keys(packed, candidates, pix, depth, chunk_lb=lb)
        if layout == "pk":
            return (t1.transpose(1, 2).contiguous(),
                    sid.transpose(1, 2).contiguous())
        return t1, sid

    return {f"{layout} lb={'on' if lb is not None else 'off'}":
            (lambda lb=lb, layout=layout: run(lb, layout))
            for layout in ("kp", "pk") for lb in (chunk_lb, None)}


def forms_agree(outs: dict) -> dict:
    """Whether each form's (t1, sid) equals the first form's bitwise, read
    in the (T, K, P) layout."""
    def kp(tag, o):
        return [x.transpose(1, 2) if tag.startswith("pk") else x for x in o]

    tags = list(outs)
    ref = kp(tags[0], outs[tags[0]])
    return {tag: all(torch.equal(a, b)
                     for a, b in zip(ref, kp(tag, outs[tag])))
            for tag in tags}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=100_000)
    ap.add_argument("w", type=int, nargs="?", default=640)
    ap.add_argument("h", type=int, nargs="?", default=384)
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--cand", type=int, default=1536)
    ap.add_argument("--glob", type=int, default=128)
    ap.add_argument("--narrow", type=int, default=3)
    ap.add_argument("--iters", type=int, default=7)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = _common.device_of(args.device)
    packed, cand, lb, pix, _ = _common.scene_tables(
        args.n, args.w, args.h, args.cand, args.glob, args.narrow, dev)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain versions)")
    print(f"# device={kind} tiles={cand.shape[0]} cand={cand.shape[1]} "
          f"mean_count={float(_counts(cand).float().mean()):.0f}",
          flush=True)

    def line(label, fn):
        ms, lo = _common.median_ms(fn, args.iters, dev)
        print(f"{label:24s} {ms:8.3f} ms   (min {lo:.3f})", flush=True)

    forms = keys_forms(packed, cand, lb, pix, args.depth)
    outs = {}
    for tag, fn in forms.items():
        line(tag, fn)
        outs[tag] = fn()
    first = next(iter(outs))
    for tag, same in forms_agree(outs).items():
        print(f"  {tag}: bitwise == {first}: {same}", flush=True)
        if not same:
            raise RuntimeError(f"keys form {tag!r} differs from {first!r}")

    t, p = cand.shape[0], pix.shape[1]
    for tsub in (t, t // 4, t // 16):
        sub = cand[:tsub].contiguous()
        for name in FLOOR_VARIANTS:
            line(f"floor {name} t={tsub}",
                 lambda: floor(name, packed, sub, p, args.depth))


if __name__ == "__main__":
    main()
