"""Full-frame image quality at the bench configurations (port of
``scripts/imquality.py``): PSNR, SSIM, mean and p99 |diff| of the
production renders against their plain twins and against the brute-force
oracle, at the bench resolutions, not in crops.

    python -m rtgs_tpu_torch.probes.imquality [config_idx ...] [--device cuda]

Configurations: ``_common.BENCH_CONFIGS`` (100k @ 640×384, 250k @
1280×720, 1M @ 1920×1088; default all), on the bench scene and pose, depth
16. Two production rows a configuration:

  keys  ``render_tiled_keys`` with the keys kernel (``keys.cu`` on the
        card); its twin the same call with the plain keys selection
        (``keys_impl="torch"``). The script's own row.
  auto  the default render (``render(renderer="auto")``: ``pallas``, the
        fused kernel ``peel_fwd.cu``, on the card above 4096 splats); its
        twin the same dispatch with the plain peel
        (``peel_impl="torch"``, ``peel_fused_torch``). Where ``auto``
        resolves to a plain renderer (the oracle at 4096 splats or fewer,
        ``tiled`` on the CPU) the twin is the same call.

The twins run in tile bands, as the script's: 8, or more where a band
would hold more than 96 tiles (their float64 (tiles, 256, C) fields are
built whole per band). The oracle (``render_oracle``,
``pixel_chunk=512``) runs only where N·W·H ≤ 2.5e11, as in the script:
100k @ 640×384 and 250k @ 1280×720. Each row carries each render's wall
time (host clock with a sync). The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from rtgs_tpu_torch.probes import _common

ORACLE_LIMIT = 2.5e11
TWIN_BANDS, TWIN_TILES = 8, 96
DEPTH = 16


def metrics(a, b) -> dict:
    """The script's four numbers for images ``a`` and ``b`` (W, H, 3):
    PSNR (``train.loss.psnr``, the MSE clamped at 1e-12: identical frames
    read 120.0 dB) and SSIM on the tensors' device, mean and p99 |diff| in
    numpy on the host; rounded as the script rounds them."""
    from rtgs_tpu_torch.train.loss import psnr, ssim

    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    d = np.abs(ta.cpu().numpy() - tb.cpu().numpy())
    return {
        "psnr_db": round(float(psnr(ta, tb)), 2),
        "ssim": round(float(ssim(ta, tb)), 5),
        "mean_absdiff": round(float(d.mean()), 6),
        "p99_absdiff": round(float(np.quantile(d, 0.99)), 6),
        "max_absdiff": float(d.max()),
    }


def _timed(fn, device):
    _common.sync(device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        img = fn()
    _common.sync(device)
    return img, (time.perf_counter() - t0) * 1e3


def run_config(cfg: dict, device: torch.device, g=None, log=print) -> dict:
    """The rows of one configuration (``label``, ``n``, ``res``,
    ``max_candidates``, ``bin_narrow``, ``tile_bands``); ``g`` defaults to
    the bench scene of ``n`` splats on ``device``."""
    from rtgs_tpu_torch.render.api import render, resolve_renderer
    from rtgs_tpu_torch.render.oracle import render_oracle
    from rtgs_tpu_torch.render.tiled import render_tiled_keys
    from rtgs_tpu_torch.scene import random_scene

    if g is None:
        g = random_scene(cfg["n"], device=device, **_common.BENCH_SCENE)
    cam = _common.bench_camera(cfg["res"], device)
    kw = dict(depth=DEPTH, tile=(16, 16),
              max_candidates=cfg["max_candidates"],
              max_global=_common.BENCH_MAX_GLOBAL,
              bin_narrow=cfg["bin_narrow"])
    if cfg.get("tile_bands"):
        kw["tile_bands"] = cfg["tile_bands"]
    tiles = -(-cfg["res"][0] // 16) * -(-cfg["res"][1] // 16)
    twin_kw = dict(kw, tile_bands=max(TWIN_BANDS, -(-tiles // TWIN_TILES)))
    resolved = resolve_renderer("auto", g.num, g.device)
    auto_twin = dict(twin_kw, peel_impl="torch") if resolved == "pallas" \
        else kw
    renders = {
        "keys": (lambda: render_tiled_keys(g, cam, **kw),
                 lambda: render_tiled_keys(g, cam, keys_impl="torch",
                                           **twin_kw)),
        "auto": (lambda: render(g, cam, **kw),
                 lambda: render(g, cam, renderer=resolved, **auto_twin)),
    }
    w, h = cfg["res"]
    with_oracle = g.num * w * h <= ORACLE_LIMIT
    oracle = None
    if with_oracle:
        oracle, ms_oracle = _timed(lambda: render_oracle(
            g, cam, depth=DEPTH, pixel_chunk=512), device)
        log(f"[{cfg['label']}] oracle render {ms_oracle:.0f} ms")
    else:
        log(f"[{cfg['label']}] oracle skipped (O(N*rays) too large)")
    rows = []
    for name, (prod_fn, twin_fn) in renders.items():
        _timed(prod_fn, device)                           # warm-up
        prod, ms_prod = _timed(prod_fn, device)
        twin, ms_twin = _timed(twin_fn, device)
        row = {"config": cfg["label"], "row": name,
               "renderer": "keys" if name == "keys" else resolved,
               "res": [w, h], "prod_ms": ms_prod, "twin_ms": ms_twin,
               "prod_vs_twin": metrics(prod, twin)}
        if oracle is not None:
            row["oracle_ms"] = ms_oracle
            row["prod_vs_oracle"] = metrics(prod, oracle)
            row["twin_vs_oracle"] = metrics(twin, oracle)
        log(json.dumps(row))
        rows.append(row)
        del prod, twin
    return {"rows": rows, "oracle": with_oracle}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("configs", type=int, nargs="*")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = _common.device_of(args.device)
    idxs = args.configs or list(range(len(_common.BENCH_CONFIGS)))
    rows = []
    for i in idxs:
        rows += run_config(_common.BENCH_CONFIGS[i], dev,
                           log=lambda m: print(m, flush=True))["rows"]
    print(json.dumps({"imquality": rows}))


if __name__ == "__main__":
    main()
