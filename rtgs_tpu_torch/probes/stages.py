"""Stage times of the render and training pipelines (port of
``scripts/kbench.py``, ``scripts/keystage.py`` and ``scripts/stageprobe.py``,
one module for the three):

    python -m rtgs_tpu_torch.probes.stages [n] [w] [h] [--cand 1536]
        [--glob 128] [--bands 0] [--narrow 3] [--depth 16]
        [--renderer keys|pallas] [--iters 5] [--device cuda]

On the bench scene and pose, each stage on inputs built before it is
timed (CUDA events on the card, the host clock on the CPU, where the
numbers time the plain versions and are no device metric), median of
``--iters`` after a warm-up:

  binning       ``tile_candidates`` (with ``chunk_lb`` on the keys path)
  feature pack  ``precompute_features`` + ``pack_features``
  pixel table   ``_tile_pixel_features``
  kernel        the keys kernel (``peel_keys``) or the fused forward
                (``peel_fused``) alone; with ``--bands`` > 1 on the first
                band's tiles only (1/bands of the frame)
  shade+comp    ``shade_winners_kp`` + ``composite_layers_kp`` on the
                kernel's winners (keys path), the same tiles
  full fwd      ``render_tiled_keys`` / ``render_tiled_pallas``
  full step     the gradient of Σ image for every scene field

The last line is one JSON object of the stages' ms. :func:`stage_times`
(a keys-path frame split into its stages, every band) and
:func:`step_stages` (one ``pallas`` training step split into its stages)
are the splits ``chip_smoke.py`` prints.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.nn.functional as F

from rtgs_tpu_torch.probes import _common

SCENE_FIELDS = ("means", "quats", "scales", "colors", "opacities", "sh")


class _Marks:
    """Timestamps on the stream: CUDA events on the card, the host clock
    elsewhere. ``ms(a, b)`` is the time between two marks."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __call__(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def wait(self, mark):
        if self.cuda:
            mark.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def stage_times(g, cam, kw, depth: int = 16, tile=(16, 16)):
    """Per-stage times of one banded keys-path frame, in ms: features
    (packed and pixel tables), the entry bound, binning, and summed over
    the ``kw["tile_bands"]`` bands the keys kernel, shade and composite;
    ``total`` from first mark to last."""
    from rtgs_tpu_torch.ops.peel import CHUNK, peel_keys
    from rtgs_tpu_torch.render.binning import tile_candidates
    from rtgs_tpu_torch.render.tiled import (_tile_pixel_features,
                                             composite_layers_kp,
                                             entry_lower_bound,
                                             pack_features,
                                             precompute_features,
                                             shade_winners_kp)

    mark = _Marks(g.device)
    marks = {"features": [], "entry bound": [], "binning": [], "keys": [],
             "shade": [], "composite": []}
    e0 = mark()
    packed = pack_features(precompute_features(g, cam))
    pix = _tile_pixel_features(cam, tile)
    e1 = mark()
    entry_lb = entry_lower_bound(g, cam, packed)
    e_lb = mark()
    b = tile_candidates(g, cam, tile=tile,
                        max_candidates=kw["max_candidates"],
                        max_global=kw["max_global"],
                        narrow=kw["bin_narrow"], chunk=CHUNK,
                        entry_lb=entry_lb)
    e2 = mark()
    marks["features"].append((e0, e1))
    marks["entry bound"].append((e1, e_lb))
    marks["binning"].append((e_lb, e2))
    t = b.candidates.shape[0]
    nb = -(-t // (kw.get("tile_bands") or 1))
    for s in range(0, t, nb):
        a = mark()
        _, sid = peel_keys(packed, b.candidates[s:s + nb], pix[s:s + nb],
                           depth, chunk_lb=b.chunk_lb[s:s + nb],
                           counts=b.counts[s:s + nb])
        k = mark()
        layers = shade_winners_kp(packed, sid, pix[s:s + nb])
        sh = mark()
        composite_layers_kp(*layers)
        c = mark()
        marks["keys"].append((a, k))
        marks["shade"].append((k, sh))
        marks["composite"].append((sh, c))
    end = mark()
    mark.wait(end)
    out = {name: sum(mark.ms(s, e) for s, e in pairs)
           for name, pairs in marks.items()}
    out["total"] = mark.ms(e0, end)
    return out


def step_stages(solver, kw, tile=(16, 16)):
    """Times (ms) of the stages of one training step at view 0, as
    ``render_tiled_pallas`` and the solver's step run them: binning,
    features, the fused forward, the loss, the backward, Adam; ``total``
    from first mark to last. The step updates the solver's parameters like
    any other."""
    from rtgs_tpu_torch.ops.peel import CHUNK, peel_fused
    from rtgs_tpu_torch.render.binning import tile_candidates
    from rtgs_tpu_torch.render.tiled import (_tile_pixel_features,
                                             _tiles_to_image, pack_features,
                                             precompute_features)
    from rtgs_tpu_torch.train.loss import render_loss
    from rtgs_tpu_torch.train.solver import activate

    cam, target = solver.cameras[0], solver.targets[0]
    w, h = cam.buf_size
    mark = _Marks(solver.mask.device)
    events = []

    def stamp(name):
        events.append((name, mark()))

    solver.optimizer.zero_grad(set_to_none=True)
    stamp("start")
    g = activate(solver.params, solver.mask)
    with torch.no_grad():
        b = tile_candidates(g, cam, tile=tile, **kw)
    cand = F.pad(b.candidates, (0, (-b.candidates.shape[1]) % CHUNK),
                 value=-1)
    stamp("binning")
    packed = pack_features(precompute_features(g, cam))
    pix = _tile_pixel_features(cam, tile)
    stamp("features")
    rad, _ = peel_fused(packed, cand, pix, solver.depth)
    stamp("peel forward")
    img = _tiles_to_image(rad.transpose(1, 2), b.n_tiles_x, b.n_tiles_y,
                          tile)[:w, :h]
    loss = render_loss(img, target, solver.cfg.lambda_dssim)
    stamp("loss")
    loss.backward()
    stamp("backward")
    solver.optimizer.step()
    stamp("adam")
    mark.wait(events[-1][1])
    out = {name: mark.ms(events[i - 1][1], e)
           for i, (name, e) in enumerate(events) if i}
    out["total"] = mark.ms(events[0][1], events[-1][1])
    return out


def _median(fn, iters, device):
    return _common.median_ms(fn, iters, device)[0]


def stage_table(n: int, w: int, h: int, device: torch.device,
                cand: int = 1536, glob: int = 128, bands: int = 0,
                narrow: int | None = 3, depth: int = 16,
                renderer: str = "keys", iters: int = 5, log=print) -> dict:
    """The stages of the module docstring at one configuration; returns
    their ms and the binning's counters."""
    from rtgs_tpu_torch.ops.peel import CHUNK, peel_fused, peel_keys
    from rtgs_tpu_torch.render.binning import tile_candidates
    from rtgs_tpu_torch.render.tiled import (_tile_pixel_features,
                                             composite_layers_kp,
                                             entry_lower_bound,
                                             pack_features,
                                             precompute_features,
                                             render_tiled_keys,
                                             render_tiled_pallas,
                                             shade_winners_kp)
    from rtgs_tpu_torch.scene import random_scene

    if renderer not in ("keys", "pallas"):
        raise ValueError(f"--renderer {renderer!r}: keys or pallas")
    keys = renderer == "keys"
    g = random_scene(n, device=device, **_common.BENCH_SCENE)
    cam = _common.bench_camera((w, h), device)
    tile = (16, 16)
    bkw = dict(tile=tile, max_candidates=cand, max_global=glob,
               narrow=narrow)
    out = {}
    with torch.no_grad():
        packed = pack_features(precompute_features(g, cam))
        lb = entry_lower_bound(g, cam, packed) if keys else None

        def binning():
            if keys:
                return tile_candidates(g, cam, chunk=CHUNK, entry_lb=lb,
                                       **bkw)
            return tile_candidates(g, cam, **bkw)

        out["binning"] = _median(binning, iters, device)
        out["feature pack"] = _median(
            lambda: pack_features(precompute_features(g, cam)), iters,
            device)
        out["pixel table"] = _median(
            lambda: _tile_pixel_features(cam, tile), iters, device)
        b = binning()
        cands = F.pad(b.candidates, (0, (-b.candidates.shape[1]) % CHUNK),
                      value=-1)
        pix = _tile_pixel_features(cam, tile)
        t = cands.shape[0]
        nb = -(-t // bands) if bands > 1 else t
        cb, pb = cands[:nb], pix[:nb]
        if keys:
            lbb, counts = b.chunk_lb[:nb], b.counts[:nb]
            out["kernel"] = _median(lambda: peel_keys(
                packed, cb, pb, depth, chunk_lb=lbb, counts=counts), iters,
                device)
            _, sid = peel_keys(packed, cb, pb, depth, chunk_lb=lbb,
                               counts=counts)
            out["shade+comp"] = _median(lambda: composite_layers_kp(
                *shade_winners_kp(packed, sid, pb)), iters, device)
        else:
            out["kernel"] = _median(
                lambda: peel_fused(packed, cb, pb, depth), iters, device)
        render_fn = render_tiled_keys if keys else render_tiled_pallas
        kw = dict(depth=depth, tile=tile, max_candidates=cand,
                  max_global=glob, bin_narrow=narrow,
                  tile_bands=bands if bands > 1 else None)
        out["full fwd"] = _median(lambda: render_fn(g, cam, **kw), iters,
                                  device)
    leaves = {f: getattr(g, f).detach().clone().requires_grad_()
              for f in SCENE_FIELDS}
    scene = type(g)(mask=g.mask, **leaves)

    def step():
        for x in leaves.values():
            x.grad = None
        render_fn(scene, cam, **kw).sum().backward()

    out["full step"] = _median(step, iters, device)
    dropped = int(b.local_overflow) + int(b.global_overflow)
    rays = w * h
    for name, ms in out.items():
        part = (f" (first {nb} of {t} tiles)"
                if name in ("kernel", "shade+comp") and nb < t else "")
        log(f"{name:12s} {ms:9.3f} ms   {rays / ms / 1e3:8.2f} Mrays/s"
            f"{part}")
    return dict(stages_ms=out, tiles=t, band_tiles=nb, dropped=dropped,
                candidates=int(cands.shape[1]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=100_000)
    ap.add_argument("w", type=int, nargs="?", default=640)
    ap.add_argument("h", type=int, nargs="?", default=384)
    ap.add_argument("--cand", type=int, default=1536)
    ap.add_argument("--glob", type=int, default=128)
    ap.add_argument("--bands", type=int, default=0)
    ap.add_argument("--narrow", type=int, default=3)
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--renderer", type=str, default="keys",
                    choices=["keys", "pallas"])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = _common.device_of(args.device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain versions; host clock)")
    print(f"# device={kind} n={args.n} res={args.w}x{args.h} "
          f"depth={args.depth} cand={args.cand}+{args.glob} "
          f"narrow={args.narrow} bands={args.bands} "
          f"renderer={args.renderer}", flush=True)
    res = stage_table(args.n, args.w, args.h, dev, cand=args.cand,
                      glob=args.glob, bands=args.bands, narrow=args.narrow,
                      depth=args.depth, renderer=args.renderer,
                      iters=args.iters,
                      log=lambda m: print(m, flush=True))
    print(json.dumps(dict(res, n=args.n, res=[args.w, args.h],
                          renderer=args.renderer, device=kind)))


if __name__ == "__main__":
    main()
