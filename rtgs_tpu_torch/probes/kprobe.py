"""Cost breakdown of the fused forward peel by ablation (port of
``scripts/kprobe.py``): kernels of increasing work on one scene's candidate
data, all with the production kernel's geometry (one block per tile, one
thread per pixel, rows staged from ``packed[cand]``, the swept prefix cut at
the tile's count), ``ops/csrc/probe_ablate.cu``.

    python -m rtgs_tpu_torch.probes.kprobe [n] [w] [h] [--depth 16]
        [--cand 512] [--glob 128] [--variants a,b,...] [--iters 8]
        [--device cuda]

Variants, each a function (packed, candidates, counts, pix) → (T, 4, P)
f32, lane 0 of the (t1, qa, r, g) state it would carry:

  empty         — pix lanes 0-3 plus 1e-30 × lane 0 of the tile's first
                  candidate row: the launch-and-write floor of the shape
                  (the port never materializes the (T, C, 64) gather, so
                  one row and the pixel block are all it reads);
  intersect     — the minimum float64 entry depth over the swept
                  candidates; channels 1-3 keep the initial state
                  (−inf, 0, 0);
  merge_t1      — the production sweep (f32 screen, float64 chain on its
                  survivors, top-K merge): the nearest t1 in all four
                  channels (no hit: +inf, 0, 0, 0);
  shade_nomerge — intersect plus the whole shading of every candidate;
  shade_qa      — intersect plus the log-domain response only;
  shade_dots    — intersect plus the three SH dot products only;
  prod          — the production kernel (``peel_fwd.cu`` through
                  :func:`~rtgs_tpu_torch.ops.peel.peel_fused_cuda`):
                  radiance and transmittance;
  prod_static   — the same, sweeping every chunk of every tile (bitwise
                  ``prod``: padding slots never hit).

The three shade variants min-reduce their shading into channel 1, which
starts at ``qa_init``; a candidate that the ray misses contributes
``qa_miss`` to ``shade_nomerge`` and ``shade_qa``. Both are −inf in the
probe, as in the TPU probe, so there channel 1 stays −inf and the result is
``intersect``'s: the variants differ in work only. With +inf for both,
channel 1 is the minimum of the shading terms over the candidates that hit
(over every swept candidate for ``shade_dots``): the form in which the
kernels' shading is held against the plain version. One line per variant: milliseconds (CUDA events, median of
``--iters``), the step over the previous variant, Mrays/s.
"""

from __future__ import annotations

import argparse
import math

import torch

from rtgs_tpu_torch.ops._launch import Launcher, check_tensors
from rtgs_tpu_torch.ops.peel import (CHUNK, F_DIM, G_DIM, _counts, _safe_ids,
                                     _select, _shade_layers, entry_depth,
                                     peel_fused_cuda, peel_fused_torch)
from rtgs_tpu_torch.probes import _common

# The kernels' enum (ops/csrc/probe_ablate.cu), in order.
KERNEL_VARIANTS = ("empty", "intersect", "merge_t1", "shade_nomerge",
                   "shade_qa", "shade_dots")
VARIANTS = KERNEL_VARIANTS + ("prod", "prod_static")
DEFAULT_VARIANTS = ("empty", "intersect", "merge_t1", "shade_nomerge",
                    "prod", "prod_static")


SHADE_VARIANTS = ("shade_nomerge", "shade_qa", "shade_dots")


def _shade_min(name: str, rows, pix, t1, swept, qa_miss: float):
    """The minimum over a tile's swept live candidates of a shade
    variant's f32 term, (T, P); +inf where there is none. ``rows``
    (T, C, 64), ``t1`` (T, P, C) the entry depths, ``swept`` (T, C). The
    operations and their order are the kernel's (``quad`` and ``color`` of
    ``peel_common.cuh``, which ``_shade_layers`` restates); a candidate the
    ray misses gives ``qa_miss`` in ``shade_nomerge`` and ``shade_qa``."""
    # _shade_layers takes (T, K, P, 64) rows: the candidates stand for K.
    a, b, _rho, _alpha, rgb = _shade_layers(
        rows[:, :, None], pix, torch.zeros((), dtype=torch.bool,
                                           device=pix.device))
    if name == "shade_dots":
        term = torch.stack([rgb[ch] - rows[:, :, None, 11 + ch]
                            for ch in range(3)]).amin(dim=0)     # (T, C, P)
    else:
        cq, op = rows[:, :, None, 9], rows[:, :, None, 10]
        hit = (torch.isfinite(t1.transpose(1, 2))
               & (b * b - (4.0 * a) * cq > 0.0))
        term = b * b / (4.0 * a) - (cq + 3.0) + torch.log(op)
        term = torch.where(hit, term, qa_miss)
        if name == "shade_nomerge":
            term = term + rgb[0] + rgb[1] + rgb[2]
    return torch.where(swept[:, :, None], term, math.inf).amin(dim=1)


def ablate_torch(name: str, packed, candidates, counts, pix, depth: int,
                 qa_init: float = -math.inf, qa_miss: float = -math.inf):
    """The plain torch version of variant ``name``. (T, 4, P) f32.
    ``qa_init`` and ``qa_miss``: see the module's text; the shading is
    evaluated only where they let it show (``qa_init`` above −inf)."""
    if name not in VARIANTS:
        raise ValueError(f"unknown kprobe variant {name!r}")
    t, p = pix.shape[0], pix.shape[1]
    if name in ("prod", "prod_static"):
        rad, trans, _ = peel_fused_torch(packed, candidates, pix, depth)
        return torch.cat([rad, trans[:, None]], dim=1)
    if name == "empty":
        f00 = packed[_safe_ids(packed, candidates[:, 0]), 0]
        out = pix[:, :, :4].transpose(1, 2).clone()
        out[:, 0] = out[:, 0] + (f00 * 1e-30)[:, None]
        return out
    # A slot at or beyond the tile's swept prefix is not read.
    nc = (counts + CHUNK - 1) // CHUNK
    lane = torch.arange(candidates.shape[1], device=candidates.device)
    cand = torch.where(lane[None, :] < (nc * CHUNK)[:, None], candidates, -1)
    out = torch.zeros((t, 4, p), dtype=torch.float32, device=pix.device)
    out[:, 1] = qa_init
    if name == "merge_t1":
        t1 = _select(packed, cand, pix, depth)[0][:, 0]          # (T, P)
        pay = torch.where(torch.isfinite(t1), t1, 0.0)
        swept = (nc > 0)[:, None]
        out[:, 0] = t1
        for ch in (1, 2, 3):
            out[:, ch] = torch.where(swept, pay, out[:, ch])
        return out
    shades = name in SHADE_VARIANTS and qa_init > -math.inf
    rows = (packed if shades else packed[:, :10])[_safe_ids(packed, cand)]
    t1 = entry_depth(rows, pix)
    out[:, 0] = t1.amin(dim=2)
    if shades:
        out[:, 1] = torch.minimum(
            out[:, 1], _shade_min(name, rows, pix, t1, cand >= 0, qa_miss))
    return out


def prod_counts(name: str, candidates, counts):
    """The counts that ``prod`` (the tiles' own) and ``prod_static`` (every
    chunk swept) give the production kernel."""
    if name == "prod":
        return counts
    t, c = candidates.shape
    return torch.full((t,), c, dtype=torch.int32, device=candidates.device)


_ABLATE = Launcher("rtgs_probe_ablate", "kprobe")


def ablate_cuda(name: str, packed, candidates, counts, pix, depth: int,
                qa_init: float = -math.inf, qa_miss: float = -math.inf):
    """Launch variant ``name`` on the current stream: ``probe_ablate.cu``
    for the six ablations, the production forward kernel for ``prod`` and
    ``prod_static``. Inputs: contiguous CUDA tensors, packed (N+1, 64) f32,
    candidates (T, C) i32 with C a multiple of 128, counts (T,) i32, pix
    (T, P, 24) f32. Raises on a wrong input or a failed launch;
    ``ablate_cuda.launches`` counts the launches of ``probe_ablate.cu``."""
    if name not in VARIANTS:
        raise ValueError(f"unknown kprobe variant {name!r}")
    if name in ("prod", "prod_static"):
        rad, trans, _ = peel_fused_cuda(
            packed, candidates, prod_counts(name, candidates, counts), pix,
            depth)
        return torch.cat([rad, trans[:, None]], dim=1)
    t, c = candidates.shape
    p = pix.shape[1]
    dev = check_tensors(f"kprobe {name}", [
        ("packed", packed, torch.float32, (packed.shape[0], F_DIM)),
        ("candidates", candidates, torch.int32, (t, c)),
        ("counts", counts, torch.int32, (t,)),
        ("pix", pix, torch.float32, (t, p, G_DIM))])
    if c % CHUNK or c < CHUNK or not 1 <= p <= 1024 or not 1 <= depth <= 64:
        raise ValueError(f"kprobe {name}: C={c} must be a positive multiple "
                         f"of {CHUNK}, P={p} in 1..1024, depth in 1..64")
    out = torch.empty((t, 4, p), dtype=torch.float32, device=dev)
    if t == 0:
        return out
    _ABLATE(dev, KERNEL_VARIANTS.index(name), packed.data_ptr(),
            candidates.data_ptr(), counts.data_ptr(), pix.data_ptr(),
            out.data_ptr(), t, c, p, depth, packed.shape[0] - 1, qa_init,
            qa_miss)
    ablate_cuda.launches += 1
    return out


ablate_cuda.launches = 0


def ablate(name: str, packed, candidates, counts, pix, depth: int,
           qa_init: float = -math.inf, qa_miss: float = -math.inf):
    """Variant ``name``: the kernel for CUDA tensors (or an error), the
    plain version for CPU tensors."""
    fn = ablate_torch if packed.device.type == "cpu" else ablate_cuda
    return fn(name, packed, candidates, counts, pix, depth, qa_init, qa_miss)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=100_000)
    ap.add_argument("w", type=int, nargs="?", default=640)
    ap.add_argument("h", type=int, nargs="?", default=384)
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--cand", type=int, default=512)
    ap.add_argument("--glob", type=int, default=128)
    ap.add_argument("--narrow", type=int, default=None)
    ap.add_argument("--variants", type=str,
                    default=",".join(DEFAULT_VARIANTS))
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = _common.device_of(args.device)
    packed, cand, _lb, pix, binning = _common.scene_tables(
        args.n, args.w, args.h, args.cand, args.glob, args.narrow, dev)
    counts = _counts(cand)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain versions)")
    dropped = int(binning.local_overflow) + int(binning.global_overflow)
    print(f"# device={kind} tiles={cand.shape[0]} cand={cand.shape[1]} "
          f"mean_count={float(counts.float().mean()):.0f} dropped={dropped}",
          flush=True)
    rays = args.w * args.h
    prev = 0.0
    for name in args.variants.split(","):
        def fn():
            if dev.type == "cpu":
                return ablate_torch(name, packed, cand, counts, pix,
                                    args.depth)
            if name in ("prod", "prod_static"):
                # The production kernel's launch alone, as it writes.
                return peel_fused_cuda(
                    packed, cand, prod_counts(name, cand, counts), pix,
                    args.depth)
            return ablate_cuda(name, packed, cand, counts, pix, args.depth)

        ms, _ = _common.median_ms(fn, args.iters, dev)
        print(f"{name:13s}: {ms:8.3f} ms  (+{ms - prev:8.3f} ms)  "
              f"{rays / ms / 1e3:8.2f} Mrays/s", flush=True)
        prev = ms


if __name__ == "__main__":
    main()
