"""The numbers that decide ``correct``: each a gap between what the timed
path produced and what the reference gives, held to a limit of the cell's
file."""

from __future__ import annotations

import statistics

import torch

TILE = 16


def tile_mean_max(err: torch.Tensor) -> float:
    """The worst 16×16 tile's mean of ``err`` (W, H); partial tiles at the
    edges count as what they hold."""
    err = err.to(torch.float64)
    w, h = err.shape
    pw, ph = -(-w // TILE) * TILE - w, -(-h // TILE) * TILE - h
    ones = torch.ones_like(err)
    err = torch.nn.functional.pad(err, (0, ph, 0, pw))
    ones = torch.nn.functional.pad(ones, (0, ph, 0, pw))
    tiles = err.reshape(-1, TILE, err.shape[1] // TILE, TILE).sum((1, 3))
    seen = ones.reshape(-1, TILE, ones.shape[1] // TILE, TILE).sum((1, 3))
    return float((tiles / seen).max())


def tile_err_max(img: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst 16×16 tile's mean |img − ref| over its pixels and
    channels, for frames (W, H, 3). A local fault (a tile, a band, a dropped
    splat) moves it as much as a global one; sparse reorders of near-tied
    hits, which change single pixels, barely move it."""
    return tile_mean_max((img.to(torch.float64)
                          - ref.to(torch.float64)).abs().mean(-1))


def winners_gap(count: torch.Tensor, ref: torch.Tensor, depth: int) -> float:
    """The worst 16×16 tile's mean |count − ref| / ``depth``, for each
    pixel's number of layers composited (W, H): min(hits, K) on both sides.
    Layers far behind the first carry almost no light, so the image cannot
    tell a frame that drops them (a pass of a deep peel, a sweep stopped
    early); the count does."""
    return tile_mean_max((count.to(torch.float64)
                          - ref.to(torch.float64)).abs() / depth)


def leaf_gaps(prog: dict, ref: dict, leaves) -> dict:
    """Each leaf's |‖prog‖ − ‖ref‖| over its own reference norm."""
    return {k: abs(prog[k] - ref[k]) / max(ref[k], 1e-300) for k in leaves}


def train_gaps(prog: dict, ref: dict, per_leaf: dict | None = None) -> dict:
    """The fit cell's numbers from the program's and the reference's
    ``losses``, ``grad_norms`` and ``change_norms``
    (:func:`benchmark.reference.train.steps`): the worst step's relative
    loss gap, and the worst leaf's gap of the first gradient's norm and of
    the change's norm over the steps, each against the leaf's own reference
    norm. Leaves whose reference gradient is below a thousandth of the
    median leaf's (which Adam moves by round-off alone) are left out of
    both. ``per_leaf``, if given, receives each leaf's two gaps."""
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["losses"], ref["losses"]))
    med = statistics.median(ref["grad_norms"].values())
    kept = [k for k, g in ref["grad_norms"].items() if g >= 1e-3 * med]
    grad = leaf_gaps(prog["grad_norms"], ref["grad_norms"], kept)
    change = leaf_gaps(prog["change_norms"], ref["change_norms"], kept)
    if per_leaf is not None:
        per_leaf.update({k: (grad[k], change[k]) for k in kept})
    return dict(loss_gap=loss_gap, grad_gap=max(grad.values()),
                change_gap=max(change.values()))
