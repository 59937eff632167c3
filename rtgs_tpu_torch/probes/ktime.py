"""Time the production kernels at the bench shapes, with and without the
wrapper's host time, optionally from edited sources.

    python -m rtgs_tpu_torch.probes.ktime [--iters 9] [--big]
        [--segment] [--sub FILE::OLD::NEW ...] [--drop-flag FLAG ...] [--label TEXT]

Times, on the bench scene (see :func:`_common.scene_tables`):

* the keys kernel (``peel_keys_cuda``) at 100k @ 640x384, budget 1536,
  narrow 3, with the early-exit bounds;
* the fused forward (``peel_fused_cuda``), the top-K forward
  (``peel_topk_cuda``), the fused backward (``peel_fused_bwd_cuda``) and the
  top-K backward (``peel_topk_bwd_cuda``) at the fit configuration, 100k @
  512x384, budget 1536: each backward kernel alone (its pair rows), the
  segment sum of the fused one's pair rows (``segment_rows.cu``) and each
  backward with its segment sum into the (N+1, 64) table (what a training
  step pays), and beside them the zero-fills of a dense (T, C, 64) block
  and of the table, and the ``index_add_`` of such a block alone (what the
  first port paid);
* with ``--big`` the same at 1M @ 256x192, budget 3584, narrow 4;
* with ``--segment`` only the segment sum (``segment_rows_cuda``), at the
  four shapes the backwards give it (:func:`segment_inputs`): its time
  split by what runs on the card (each kernel, the sort's and the fills'
  included) and the host's share, beside ``index_add_`` and its bound, with
  the run lengths of the ids (:func:`run_lengths`).

Each line: the wrapper's time (CUDA events around the call, median of
``--iters``: host time of the call included), the device time with the
stream kept busy (:func:`_common.busy_ms`) and the device time of what the
call runs on the card, from ``torch.profiler`` (:func:`kernels_ms`).

``--sub`` builds the kernels from a temporary copy of ``ops/csrc`` in which
``OLD`` is replaced by ``NEW`` in ``FILE`` (the text must occur), and
``--drop-flag`` removes an ``nvcc`` flag: throw-away experiments that ask
what a kernel costs without one of its parts (a hit test forced false, an
atomic turned into a plain store). The results of such a build are wrong
by design; only its times are read. The repository's sources and build
directory are not touched.
"""

from __future__ import annotations

import argparse
import pathlib
import shutil
import tempfile

import torch

from rtgs_tpu_torch.ops import _build
from rtgs_tpu_torch.ops import peel
from rtgs_tpu_torch.probes import _common

DEPTH = 16
SHAPES = {
    "keys": ("100k@640x384", 100_000, 640, 384, 1536, 3),
    "fit": ("100k@512x384", 100_000, 512, 384, 1536, None),
    "big": ("1M@256x192", 1_000_000, 256, 192, 3584, 4),
}
# One band of the keys path's forward+backward at 1M @ 1920x1088: budgets
# 3584 / 128 / narrow 4, eight tile bands.
FULL = ("1M@1920x1088", 1_000_000, 1920, 1088, 3584, 4)
BANDS = 8
# Peak device-memory rate of one H100 SXM (NVIDIA's data sheet).
HBM_BPS = 3.35e12


def edited_sources(subs, tmp: pathlib.Path) -> None:
    """Point ``ops/_build`` at a copy of the sources with ``subs`` applied."""
    src = tmp / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    for spec in subs:
        name, old, new = spec.split("::")
        path = src / name
        text = path.read_text()
        if old not in text:
            raise ValueError(f"--sub: {old!r} does not occur in {name}")
        path.write_text(text.replace(old, new))
    _build.SRC_DIR = src
    _build.BUILD_DIR = tmp / "build"


def kernels_ms(fn, iters: int) -> float:
    """Device milliseconds of what one ``fn()`` runs on the card (kernels,
    copies and fills; :func:`kernels_by_name` summed): the kernels' own
    time also where the wrapper waits on the card (the backwards read the
    pair count to the host), which defeats the busy-stream measure."""
    return sum(kernels_by_name(fn, iters).values())


def kernels_by_name(fn, iters: int) -> dict:
    """Device milliseconds a call of ``fn()`` spends in each kernel, copy
    or fill, by name (``torch.profiler``, ``iters`` calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            name = short_name(e.key)
            out[name] = (out.get(name, 0.0)
                         + e.self_device_time_total / iters / 1e3)
    return out


def short_name(kernel: str) -> str:
    """A kernel's name without its namespaces, template arguments and
    parameters (``cub::DeviceRadixSortOnesweepKernel<...>(...)`` →
    ``DeviceRadixSortOnesweepKernel``)."""
    name = kernel.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


def run_lengths(ids: torch.Tensor, n_out: int) -> dict:
    """How the ids fall into runs: the share of the ``n_out`` rows that an
    id names, and the median, 0.99 quantile and longest run of those."""
    keep = ids[(ids >= 0) & (ids < n_out)].long()
    runs = torch.bincount(keep, minlength=n_out)
    named = runs[runs > 0].double()
    if not named.numel():
        return dict(named=0.0, median=0, p99=0, longest=0, over32=0)
    return dict(named=named.numel() / n_out,
                median=float(torch.quantile(named, 0.5)),
                p99=float(torch.quantile(named, 0.99)),
                longest=int(named.max()),
                over32=int((named > 32).sum()))


def segment_bound_ms(m: int, n_out: int) -> float:
    """The segment sum's bound: M rows of 64 f32 and their ids read once,
    ``n_out`` rows written once, over the memory rate (its one add a lane
    and row is far below the f32 peak)."""
    return ((m + n_out) * 64 * 4 + 4 * m) / HBM_BPS * 1e3


def segment_inputs(dev: torch.device) -> dict:
    """The segment sum's inputs at the four shapes its callers give it, on
    the bench scene: (a) the fused backward's pair rows at the fit
    configuration (100k @ 512x384); (b) the keys path's winner ids there,
    as its shade backward lists them ((t, k, p) order, repeats); (c) the
    fused backward's pair rows at 1M @ 256x192; (d) the winner ids of the
    busiest of eight bands of the keys path at 1M @ 1920x1088. Winner rows
    are seeded random numbers. Returns label → (rows, ids, n_out)."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def winners(packed, cand, counts, lb, pix):
        sid = peel.peel_keys_cuda(packed, cand, counts, lb, pix, DEPTH)[1]
        ids = sid[sid >= 0].contiguous()
        return torch.randn((ids.shape[0], peel.F_DIM), generator=gen,
                           device=dev), ids

    def pairs(packed, cand, counts, pix):
        _, _, sl = peel.peel_fused_cuda(packed, cand, counts, pix, DEPTH)
        t, p = cand.shape[0], pix.shape[1]
        g_rad = torch.randn((t, 3, p), generator=gen, device=dev)
        g_tr = torch.randn((t, p), generator=gen, device=dev)
        return peel.peel_fused_bwd_cuda(packed, cand, counts, pix, sl,
                                        g_rad, g_tr, DEPTH, table=False)

    out = {}
    for key, tag in (("fit", "a"), ("big", "c")):
        label, n, w, h, cand, narrow = SHAPES[key]
        packed, cands, lb, pix, _ = _common.scene_tables(
            n, w, h, cand, 128, narrow, dev)
        counts = peel._counts(cands)
        out[f"({tag}) {label} pair rows"] = (
            *pairs(packed, cands, counts, pix), packed.shape[0])
        if key == "fit":
            out[f"(b) {label} winner rows"] = (
                *winners(packed, cands, counts, lb, pix), packed.shape[0])
    label, n, w, h, cand, narrow = FULL
    packed, cands, lb, pix, _ = _common.scene_tables(
        n, w, h, cand, 128, narrow, dev)
    counts = peel._counts(cands)
    t = cands.shape[0]
    nb = -(-t // BANDS)
    best = None
    for s in range(0, t, nb):
        b = slice(s, s + nb)
        rows, ids = winners(packed, cands[b], counts[b], lb[b], pix[b])
        if best is None or ids.shape[0] > best[1].shape[0]:
            best = rows, ids
    out[f"(d) {label} one band's winner rows"] = (*best, packed.shape[0])
    return out


def segment_line(label, rows, ids, n_out, iters, dev) -> dict:
    """One shape's numbers for ``segment_rows_cuda``: around the wrapper,
    stream kept busy, on the card (summed and by kernel), the host's share
    (around the wrapper less the card's), ``index_add_`` alone, the
    bound and the run lengths. Prints a line; returns the numbers."""
    def call():
        return peel.segment_rows_cuda(rows, ids, n_out)

    acc = torch.zeros((n_out, peel.F_DIM), device=dev)
    ids_l = ids.long()
    ms, _ = _common.median_ms(call, iters, dev)
    split = kernels_by_name(call, iters)
    dev_ms = sum(split.values())
    o = dict(m=rows.shape[0], n=n_out, ms=ms,
             busy=_common.busy_ms(call, iters, dev), device=dev_ms,
             host=ms - dev_ms, split=split,
             library_ms=_common.median_ms(
                 lambda: acc.index_add_(0, ids_l, rows), iters,
                 dev)[0],
             bound_ms=segment_bound_ms(rows.shape[0], n_out),
             runs=run_lengths(ids, n_out))
    r = o["runs"]
    print(f"segment {label}: M={o['m']} into {n_out}; {ms:.4f} ms around "
          f"the wrapper, {o['busy']:.4f} busy, {dev_ms:.4f} on the card ("
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
              split.items(), key=lambda kv: -kv[1]))
          + f"), host {o['host']:.4f}; index_add_ "
          f"{o['library_ms']:.4f}; bound {o['bound_ms']:.4f} ms; runs: "
          f"{r['named']:.1%} of rows named, median {r['median']:.0f}, p99 "
          f"{r['p99']:.0f}, longest {r['longest']}, {r['over32']} over 32",
          flush=True)
    return o


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=9)
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--segment", action="store_true")
    ap.add_argument("--sub", action="append", default=[])
    ap.add_argument("--drop-flag", action="append", default=[])
    ap.add_argument("--label", type=str, default="sources as they are")
    args = ap.parse_args(argv)
    dev = _common.device_of("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        if args.sub or args.drop_flag:
            edited_sources(args.sub, pathlib.Path(tmp))
            _build.NVCC_FLAGS = [f for f in _build.NVCC_FLAGS
                                 if f not in args.drop_flag]
        _build.load_library()
        print(f"# {args.label} | {torch.cuda.get_device_name(dev)}",
              flush=True)
        run(args, dev)


def run(args, dev):
    if args.segment:
        for label, (rows, ids, n_out) in segment_inputs(dev).items():
            segment_line(label, rows, ids, n_out, args.iters, dev)
        return

    def line(label, fn):
        ms, lo = _common.median_ms(fn, args.iters, dev)
        busy = _common.busy_ms(fn, args.iters, dev)
        print(f"{label:34s} {ms:8.4f} ms (min {lo:.4f}); stream busy "
              f"{busy:8.4f} ms; kernels {kernels_ms(fn, args.iters):8.4f} ms",
              flush=True)

    def tables(key):
        label, n, w, h, cand, narrow = SHAPES[key]
        packed, cands, lb, pix, _ = _common.scene_tables(
            n, w, h, cand, 128, narrow, dev)
        return label, packed, cands, peel._counts(cands), lb, pix

    def keys(key):
        label, packed, cand, counts, lb, pix = tables(key)
        line(f"keys {label}", lambda: peel.peel_keys_cuda(
            packed, cand, counts, lb, pix, DEPTH))

    def pair(key):
        label, packed, cand, counts, _, pix = tables(key)
        rad, tr, sl = peel.peel_fused_cuda(packed, cand, counts, pix, DEPTH)
        gen = torch.Generator(device=dev).manual_seed(0)
        g_rad = torch.randn(rad.shape, generator=gen, device=dev)
        g_tr = torch.randn(tr.shape, generator=gen, device=dev)
        g_lay = torch.randn((cand.shape[0], 4, DEPTH, pix.shape[1]),
                            generator=gen, device=dev)

        def bwd():
            return peel.peel_fused_bwd_cuda(packed, cand, counts, pix, sl,
                                            g_rad, g_tr, DEPTH)

        def topk_bwd():
            return peel.peel_topk_bwd_cuda(packed, cand, counts, pix, sl,
                                           g_lay, DEPTH)

        t, c = cand.shape
        ids = peel._safe_ids(packed, cand).reshape(-1)
        dense = torch.zeros((t * c, peel.F_DIM), device=dev)
        line(f"zero-fill (T, C, 64) {label}",
             lambda: torch.zeros((t, c, peel.F_DIM), device=dev))
        line(f"zero-fill (N+1, 64) {label}",
             lambda: torch.zeros_like(packed))
        line(f"index_add_ of (T*C, 64) {label}",
             lambda: torch.zeros_like(packed).index_add_(0, ids, dense))
        del dense
        line(f"peel_fwd {label}", lambda: peel.peel_fused_cuda(
            packed, cand, counts, pix, DEPTH))
        line(f"peel_topk_fwd {label}", lambda: peel.peel_topk_cuda(
            packed, cand, counts, pix, DEPTH))
        rows, pair_ids = peel.peel_fused_bwd_cuda(
            packed, cand, counts, pix, sl, g_rad, g_tr, DEPTH, table=False)
        line(f"peel_bwd pair rows {label}",
             lambda: peel.peel_fused_bwd_cuda(packed, cand, counts, pix, sl,
                                              g_rad, g_tr, DEPTH,
                                              table=False))
        line(f"segment_rows {label}", lambda: peel.segment_rows_cuda(
            rows, pair_ids, packed.shape[0]))
        del rows, pair_ids
        line(f"peel_bwd + table {label}", bwd)
        line(f"peel_topk_bwd pair rows {label}",
             lambda: peel.peel_topk_bwd_cuda(packed, cand, counts, pix, sl,
                                             g_lay, DEPTH, table=False))
        line(f"peel_topk_bwd + table {label}", topk_bwd)

    keys("keys")
    pair("fit")
    if args.big:
        keys("big")
        pair("big")


if __name__ == "__main__":
    main()
