"""Training losses (port of :mod:`rtgs_tpu.train.loss`): the 3DGS
objective

    L = (1 − λ) · L1 + λ · (1 − SSIM),   λ = 0.2,

with SSIM over the standard 11×11 Gaussian window (σ = 1.5), applied as two
separable 1-D passes with edge padding. Each pass is an explicit sum of
shifted slices, not a convolution, so no cuDNN (and no TF32) touches it.
Images are (W, H, C) in [0, 1].
"""

from __future__ import annotations

import torch


def l1_loss(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(img - target))


def _gaussian_window(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2
    w = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return w / torch.sum(w)


def _blur(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Separable 'same' filter over the two leading spatial axes of a
    (W, H, C) image, with edge padding."""
    k = window.shape[0]
    pad = k // 2

    def conv1d(x, axis):
        x = x.movedim(axis, -1)
        n = x.shape[-1]
        xp = torch.cat([x[..., :1].expand(*x.shape[:-1], pad), x,
                        x[..., -1:].expand(*x.shape[:-1], pad)], dim=-1)
        out = torch.zeros_like(x)
        for i in range(k):
            out = out + window[i] * xp[..., i:i + n]
        return out.movedim(-1, axis)

    return conv1d(conv1d(img, 0), 1)


def ssim(img: torch.Tensor, target: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, c1: float = 0.01 ** 2,
         c2: float = 0.03 ** 2) -> torch.Tensor:
    """Mean SSIM between two (W, H, C) images in [0, 1]."""
    w = _gaussian_window(window_size, sigma, device=img.device)
    mu1, mu2 = _blur(img, w), _blur(target, w)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _blur(img * img, w) - mu1_sq
    s2 = _blur(target * target, w) - mu2_sq
    s12 = _blur(img * target, w) - mu12
    num = (2 * mu12 + c1) * (2 * s12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)
    return torch.mean(num / den)


def render_loss(img: torch.Tensor, target: torch.Tensor,
                lambda_dssim: float = 0.2) -> torch.Tensor:
    """The 3DGS objective: (1−λ)·L1 + λ·(1−SSIM)."""
    return ((1 - lambda_dssim) * l1_loss(img, target)
            + lambda_dssim * (1 - ssim(img, target)))


def psnr(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((img - target) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
