"""The plain reference of the re-fit's first steps, in PyTorch alone.

A step renders the scene of the raw parameters (``means``, ``quats``
normalised on use, ``log_scales`` → exp, ``color_logits`` and
``opacity_logits`` → sigmoid, ``sh``) from one view with
:mod:`benchmark.reference.render` (the winners chosen without gradient: the
order of hits is piecewise constant), takes the 3DGS loss against that
view's target, (1 − λ)·L1 + λ·(1 − SSIM) with SSIM over an 11×11 Gaussian
window (σ 1.5) with edge padding, back-propagates through autograd and takes
one Adam step a parameter (β 0.9 / 0.999, ε 1e-15, bias-corrected; the
learning rate of each parameter's group). The targets are this module's own
renders of the unperturbed scene.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import render as R

LEAVES = ("means", "quats", "log_scales", "color_logits", "opacity_logits",
          "sh")
BETAS, EPS = (0.9, 0.999), 1e-15


def fields(raw: dict) -> dict:
    """The frame's fields (:func:`render.frame_fields`) of raw parameters,
    differentiable in them."""
    q = raw["quats"] / torch.linalg.norm(raw["quats"], dim=-1, keepdim=True)
    return dict(means=raw["means"], rot=R.rotation(q),
                inv_scales=torch.exp(-raw["log_scales"]),
                opacities=torch.sigmoid(raw["opacity_logits"]),
                colors=torch.sigmoid(raw["color_logits"]), sh=raw["sh"])


def render_raw(raw: dict, cam: R.Camera, depth: int) -> torch.Tensor:
    """The frame (W, H, 3) of raw parameters, differentiable in them."""
    f = fields(raw)
    dev, dtype = raw["means"].device, raw["means"].dtype
    with torch.no_grad():
        winners = R.select({k: v.detach() for k, v in f.items()}, cam,
                           depth, dev)
    o = cam.origin.to(device=dev, dtype=dtype)
    img = R.shade(f, o, cam.dirs(dtype, dev).reshape(-1, 3),
                  winners.reshape(-1, depth))
    return img.reshape(cam.w, cam.h, 3)


def _blur(x: torch.Tensor, size: int = 11, sigma: float = 1.5):
    """Gaussian 'same' filter of (W, H, C) over W and H, edges repeated."""
    t = torch.arange(size, dtype=x.dtype, device=x.device) - (size - 1) / 2
    k = torch.exp(-t * t / (2 * sigma * sigma))
    k = k / k.sum()
    c = x.shape[-1]
    y = x.permute(2, 0, 1)[None]                        # (1, C, W, H)
    y = F.pad(y, (size // 2,) * 4, mode="replicate")
    y = F.conv2d(y, k.reshape(1, 1, size, 1).expand(c, 1, size, 1),
                 groups=c)
    y = F.conv2d(y, k.reshape(1, 1, 1, size).expand(c, 1, 1, size),
                 groups=c)
    return y[0].permute(1, 2, 0)


def loss(img: torch.Tensor, target: torch.Tensor,
         lam: float) -> torch.Tensor:
    """(1 − λ)·mean |img − target| + λ·(1 − mean SSIM), c1 = 0.01²,
    c2 = 0.03²."""
    c1, c2 = 0.01**2, 0.03**2
    mu1, mu2 = _blur(img), _blur(target)
    s1 = _blur(img * img) - mu1 * mu1
    s2 = _blur(target * target) - mu2 * mu2
    s12 = _blur(img * target) - mu1 * mu2
    ssim = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))).mean()
    return (1 - lam) * (img - target).abs().mean() + lam * (1 - ssim)


def steps(raw0: dict, targets: list, cams: list, depth: int, lrs: dict,
          lam: float, n: int, dtype=torch.float64) -> dict:
    """``n`` steps from the raw parameters ``raw0`` (float32 tensors on the
    run's device) on views 0..n−1, in ``dtype``. Returns the loss of each
    step, the norm of each leaf's first gradient, and the norm of each
    leaf's change after the ``n`` steps."""
    raw = {k: raw0[k].detach().to(dtype).clone().requires_grad_(True)
           for k in LEAVES}
    m = {k: torch.zeros_like(v) for k, v in raw.items()}
    v2 = {k: torch.zeros_like(v) for k, v in raw.items()}
    losses, first = [], None
    for t in range(1, n + 1):
        img = render_raw(raw, cams[t - 1], depth)
        value = loss(img, targets[t - 1].to(dtype), lam)
        grads = torch.autograd.grad(value, [raw[k] for k in LEAVES])
        losses.append(float(value.detach()))
        if first is None:
            first = {k: float(torch.linalg.norm(g.double()))
                     for k, g in zip(LEAVES, grads)}
        with torch.no_grad():
            for k, g in zip(LEAVES, grads):
                m[k].mul_(BETAS[0]).add_((1 - BETAS[0]) * g)
                v2[k].mul_(BETAS[1]).add_((1 - BETAS[1]) * g * g)
                mhat = m[k] / (1 - BETAS[0] ** t)
                vhat = v2[k] / (1 - BETAS[1] ** t)
                raw[k].sub_(lrs[k] * mhat / (torch.sqrt(vhat) + EPS))
    change = {k: float(torch.linalg.norm((raw[k].detach().double()
                                          - raw0[k].double())))
              for k in LEAVES}
    return dict(losses=losses, grad_norms=first, change_norms=change)
