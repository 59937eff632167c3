"""A structured (non-uniform) N-splat scene, written as a standard
62-property 3DGS ``.ply`` (port of ``scripts/make_scene.py``): the input of
the real-scale CLI render check.

    python -m rtgs_tpu_torch.probes.make_scene [out.ply] [n] [--device cuda]

Structure: a ground plane, three Gaussian-cluster "objects" and a thin
spherical shell: surface-like density rather than a uniform box, so tile
occupancy is skewed as in a real capture. The arrays are drawn from
``np.random.default_rng(seed)`` in the script's order, so they are the
script's bit for bit. ``out.ply`` defaults to ``structured1m.ply`` in the
temporary directory.

:func:`candidate_counts` reads what the skew does to the tile binning: each
tile's candidate count before any budget cuts it, and the least budgets at
which nothing is dropped.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict

import numpy as np
import torch

from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.probes import _common

# Tiles whose candidate list is longer than this shade from device memory
# in peel_fwd.cu (its shared-memory row stage, peel_common.cuh:kShadeRows).
SMEM_SLOTS = 416


def structured_scene_arrays(n: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """The fields of :func:`structured_scene` as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    parts = []

    def add(k, pos, scale_rng):
        quats = rng.normal(size=(k, 4))
        quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
        parts.append(dict(
            means=pos,
            quats=quats,
            scales=rng.uniform(*scale_rng, (k, 3)),
            colors=rng.uniform(0.15, 0.9, (k, 3)),
            opacities=rng.uniform(0.3, 0.95, k),
            sh=rng.normal(0.0, 0.04, (k, 15, 3))))

    n_ground = n // 4
    g_xy = rng.uniform(-4.5, 4.5, (n_ground, 2))
    ground = np.stack([g_xy[:, 0], np.full(n_ground, -0.8)
                       + rng.normal(0, 0.02, n_ground), g_xy[:, 1]], 1)
    add(n_ground, ground, (0.015, 0.05))

    n_obj = n // 4
    for c in ([-1.0, -0.3, 0.0], [0.8, 0.0, 0.5], [0.0, 0.4, -1.0]):
        k = n_obj // 3
        add(k, np.asarray(c) + rng.normal(0, 0.45, (k, 3)), (0.01, 0.03))

    n_shell = n - n_ground - 3 * (n_obj // 3)
    d = rng.normal(size=(n_shell, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    shell = d * (2.2 + rng.normal(0, 0.03, (n_shell, 1)))
    add(n_shell, shell, (0.015, 0.045))

    cat = {k: np.concatenate([p[k] for p in parts], 0).astype(np.float32)
           for k in parts[0]}
    cat["mask"] = np.ones(len(cat["opacities"]), np.float32)
    return cat


def structured_scene(n: int, seed: int = 0, device="cuda") -> G.Gaussians:
    """The structured scene of ``n`` splats on ``device`` (the card unless
    asked)."""
    from rtgs_tpu_torch.scene import _from_numpy
    from rtgs_tpu_torch.utils.device import resolve_device

    return _from_numpy(resolve_device(device),
                       **structured_scene_arrays(n, seed))


def candidate_counts(g: G.Gaussians, camera, tile=(16, 16),
                     narrow: int | None = None) -> dict:
    """Each tile's candidate count before a budget cuts it, from the
    binning itself run with budgets that drop nothing: ``local`` (T,) the
    tile's own pairs, ``global`` the per-frame global list's length (every
    tile's row carries it first). ``least_candidates`` and ``least_global``
    are the least ``max_candidates`` and ``max_global`` at which the
    binning drops no pair; ``slots`` (T,) is each row's length at those
    budgets (global list + own pairs), what the kernels sweep."""
    from rtgs_tpu_torch.render.binning import tile_candidates

    with torch.no_grad():
        # A global list of one and no pair of a tile's own: the global
        # list's spill counts the rest of it.
        b = tile_candidates(g, camera, tile=tile, max_candidates=0,
                            max_global=1, narrow=narrow)
        in_row = int(b.counts[0]) if b.counts.numel() else 0
        n_glob = int(b.global_overflow) + in_row
        cand = 1024
        while True:
            b = tile_candidates(g, camera, tile=tile, max_candidates=cand,
                                max_global=1, narrow=narrow)
            if int(b.local_overflow) == 0:
                break
            cand *= 2
        own = (b.counts - in_row).cpu().numpy()
    return {"local": own, "global": n_glob,
            "least_candidates": int(own.max()) if own.size else 0,
            "least_global": n_glob, "slots": own + n_glob}


def count_summary(counts: dict) -> dict:
    """The numbers of :func:`candidate_counts` a report prints."""
    slots = counts["slots"]
    return {"tiles": int(slots.size), "max_slots": int(slots.max()),
            "p99_slots": float(np.quantile(slots, 0.99)),
            "mean_slots": float(slots.mean()),
            f"tiles_over_{SMEM_SLOTS}": int((slots > SMEM_SLOTS).sum()),
            "global": counts["global"],
            "least_candidates": counts["least_candidates"],
            "least_global": counts["least_global"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default=os.path.join(
        tempfile.gettempdir(), "structured1m.ply"))
    ap.add_argument("n", type=int, nargs="?", default=1_000_000)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    from rtgs_tpu_torch.scene import save_scene

    g = structured_scene(args.n, device=_common.device_of(args.device))
    save_scene(args.out, g)
    print(f"wrote {args.n} splats -> {args.out}", flush=True)
    print(json.dumps({"n": args.n, "out": args.out}))


if __name__ == "__main__":
    main()
