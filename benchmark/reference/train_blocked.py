"""The re-fit's first steps in pixel blocks, in PyTorch alone: the function
and gradient of :func:`benchmark.reference.train.steps`, with a peak
bounded by the block.

A step of :func:`train.steps` back-propagates one autograd graph of the
whole frame: at 1920×1088 and depth 16 that is 33 million (pixel, winner)
pairs in float64, more than a card holds. Here a step's frame is an
autograd function (:class:`_BlockedFrame`) of the raw parameters. Its
forward takes the fields (:func:`train.fields`) and the winners
(:func:`render.select`, without gradient, as there) and shades the frame
``block_pixels`` pixels at a time without gradient (:func:`render.shade`).
The loss (:func:`train.loss`) and its gradient dL/dframe are taken on the
whole frame, since SSIM's window spans blocks; that part is cheap. Its
backward shades each block again with gradient, back-propagates the
block's slice of dL/dframe into the fields (:func:`_block_grads`), sums
the fields' gradients over the blocks and takes them once through
:func:`train.fields` to the raw parameters. Each pixel's arithmetic is that
of the whole frame, so the losses are the same to the bit, and gradients
and changes differ only in the order of float64 sums
(``benchmark/tests/test_bench_fit_blocked.py`` holds them to 1e-10 of
:func:`train.steps`).

The steps, Adam and the norms are :func:`train.steps`' own, run with this
frame in place of :func:`train.render_raw` while :func:`steps_blocked`
runs.

At the cell ``fit1m_refit`` (1M splats, 1920×1088, depth 16, 3 steps),
with 65,536 pixels a block, the check (its targets and three steps) takes
9.1 s and 6.1 GiB above what the run holds, on an NVIDIA H100 80GB HBM3 at
700 W. Without the pair rows of :func:`_block_grads` the same check took
110 s there.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.reference import render as R
from benchmark.reference import train as T


class _BlockedFrame(torch.autograd.Function):
    """The frame (W, H, 3) of the raw parameters, differentiable in them,
    shaded in blocks of pixels (see the module's docstring)."""

    @staticmethod
    def forward(ctx, cam, depth, block, *leaves):
        raw = dict(zip(T.LEAVES, leaves))
        f = T.fields(raw)
        dev = raw["means"].device
        winners = R.select(f, cam, depth, dev).reshape(-1, depth)
        o = cam.origin.to(device=dev, dtype=raw["means"].dtype)
        dirs = cam.dirs(raw["means"].dtype, dev).reshape(-1, 3)
        img = torch.cat([R.shade(f, o, dirs[s:s + block],
                                 winners[s:s + block])
                         for s in range(0, dirs.shape[0], block)])
        ctx.save_for_backward(*leaves)
        ctx.block, ctx.winners, ctx.o, ctx.dirs = block, winners, o, dirs
        return img.reshape(cam.w, cam.h, 3)

    @staticmethod
    def backward(ctx, grad_img):
        leaves = [x.detach().requires_grad_(True) for x in ctx.saved_tensors]
        block, winners, o, dirs = ctx.block, ctx.winners, ctx.o, ctx.dirs
        grad_img = grad_img.reshape(-1, 3)
        with torch.enable_grad():
            f = T.fields(dict(zip(T.LEAVES, leaves)))
        f_det = {k: v.detach() for k, v in f.items()}
        acc = {k: torch.zeros_like(v) for k, v in f_det.items()}
        for s in range(0, dirs.shape[0], block):
            win = winners[s:s + block]
            ok = (win >= 0).reshape(-1)
            rows = torch.where(win >= 0, win, 0).reshape(-1)
            _block_grads(f_det, acc, rows, ok, o, dirs[s:s + block],
                         grad_img[s:s + block])
        grads = torch.autograd.grad([f[k] for k in f], leaves,
                                    [acc[k] for k in f], allow_unused=True)
        return (None, None, None, *(torch.zeros_like(x) if g is None else g
                                    for x, g in zip(leaves, grads)))


def _block_grads(f: dict, acc: dict, rows, ok, o, d, grad) -> None:
    """Add one block's gradient of ``shade`` into ``acc`` (each field's
    gradient). The block's (pixel, layer) pairs each get a row of their own:
    the winners' rows of ``f``, gathered (``rows``, 0 where vacant), with a
    vacant pair's opacity 0, so that it composites nothing, as a vacant
    layer does in :func:`render.shade`. The shade then takes its winners as
    the pairs' own rows, each once, and the rows' gradients are summed into
    the fields by winner with ``index_add_``: autograd's gather backward,
    which accumulates each repeated index in turn, took ~30 s a step at 1M
    splats on the card."""
    pairs = {k: v[rows].requires_grad_(True) for k, v in f.items()}
    own = torch.arange(rows.shape[0], device=rows.device).reshape(
        d.shape[0], -1)
    with torch.enable_grad():
        shaded = dict(pairs,
                      opacities=torch.where(ok, pairs["opacities"], 0.0))
        part = R.shade(shaded, o, d, own)
        grads = torch.autograd.grad(part, list(pairs.values()), grad)
    for k, g in zip(pairs, grads):
        acc[k].index_add_(0, rows[ok], g[ok])


def render_blocked(block_pixels: int):
    """A stand-in for :func:`train.render_raw`: the frame of raw parameters
    shaded ``block_pixels`` pixels at a time."""

    def render_raw(raw: dict, cam: R.Camera, depth: int) -> torch.Tensor:
        return _BlockedFrame.apply(cam, depth, int(block_pixels),
                                   *(raw[k] for k in T.LEAVES))

    return render_raw


@contextlib.contextmanager
def _no_tf32():
    """float32 and lower precisions as stated, not TF32, for the block."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def steps_blocked(raw0: dict, targets: list, cams: list, depth: int,
                  lrs: dict, lam: float, n: int, dtype=torch.float64,
                  block_pixels: int = 65536) -> dict:
    """What :func:`train.steps` returns for the same arguments (each
    step's loss, each leaf's first gradient norm, each leaf's change norm
    after ``n`` steps), each frame shaded and back-propagated
    ``block_pixels`` pixels at a time."""
    orig = T.render_raw
    T.render_raw = render_blocked(block_pixels)
    try:
        with _no_tf32():
            return T.steps(raw0, targets, cams, depth, lrs, lam, n, dtype)
    finally:
        T.render_raw = orig
