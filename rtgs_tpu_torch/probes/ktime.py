"""Time the production kernels at the bench shapes, with and without the
wrapper's host time, optionally from edited sources.

    python -m rtgs_tpu_torch.probes.ktime [--iters 9] [--big]
        [--sub FILE::OLD::NEW ...] [--drop-flag FLAG ...] [--label TEXT]

Times, on the bench scene (see :func:`_common.scene_tables`):

* the keys kernel (``peel_keys_cuda``) at 100k @ 640x384, budget 1536,
  narrow 3, with the early-exit bounds;
* the fused forward (``peel_fused_cuda``), the top-K forward
  (``peel_topk_cuda``), the fused backward (``peel_fused_bwd_cuda``) and the
  top-K backward (``peel_topk_bwd_cuda``) at the fit configuration, 100k @ 512x384, budget 1536; for each backward
  also the gradient of the (N+1, 64) table (where a wrapper returns
  per-slot rows (T, C, 64), the ``index_add_`` that scatters them is
  included: that is what a training step pays), and beside them the
  zero-fills of a dense (T, C, 64) block and of the table, and the
  ``index_add_`` of such a block alone;
* with ``--big`` the same at 1M @ 256x192, budget 3584, narrow 4.

Each line: the wrapper's time (CUDA events around the call, median of
``--iters``: host time of the call included) and the device time with the
stream kept busy (:func:`_common.busy_ms`).

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


def table_grad(packed, cand, dfeats):
    """The (N+1, 64) table gradient from a backward wrapper's result."""
    if dfeats.dim() == 2:
        return dfeats
    return peel._scatter_slot_grads(packed, cand, dfeats)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=9)
    ap.add_argument("--big", action="store_true")
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
    def line(label, fn):
        ms, lo = _common.median_ms(fn, args.iters, dev)
        busy = _common.busy_ms(fn, args.iters, dev)
        print(f"{label:34s} {ms:8.4f} ms (min {lo:.4f}); stream busy "
              f"{busy:8.4f} ms", flush=True)

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
        line(f"peel_bwd {label}", bwd)
        line(f"peel_bwd + table {label}",
             lambda: table_grad(packed, cand, bwd()))
        line(f"peel_topk_bwd {label}", topk_bwd)
        line(f"peel_topk_bwd + table {label}",
             lambda: table_grad(packed, cand, topk_bwd()))

    keys("keys")
    pair("fit")
    if args.big:
        keys("big")
        pair("big")


if __name__ == "__main__":
    main()
