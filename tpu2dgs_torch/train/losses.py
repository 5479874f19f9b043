"""Training losses: L1, SSIM, normal consistency, depth distortion (port
of tpu2dgs/train/losses.py).

Images are (C,H,W) float32 in [0,1]. SSIM uses the 11-tap sigma-1.5
gaussian window with zero padding, applied as two separable 1D passes of
shifted slices, as the JAX package computes it: the same sums in the same
order, and no convolution library whose float32 mode would have to be
pinned.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def l2_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


@functools.lru_cache(maxsize=4)
def _gaussian_window(window_size: int, sigma: float) -> tuple[float, ...]:
    x = np.arange(window_size, dtype=np.float32) - window_size // 2
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    return tuple(float(v) for v in (g / g.sum()).astype(np.float32))


def _filter2d_separable(img: torch.Tensor, window) -> torch.Tensor:
    """Depthwise 2D gaussian blur of (C,H,W), zero padded: a weighted sum
    of shifted slices along H, then along W."""
    k = len(window)
    pad = k // 2
    h, w = img.shape[1], img.shape[2]
    x = F.pad(img, (0, 0, pad, pad))
    x = sum(window[i] * x[:, i:i + h, :] for i in range(k))
    x = F.pad(x, (pad, pad, 0, 0))
    return sum(window[i] * x[:, :, i:i + w] for i in range(k))


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over a (C,H,W) pair (C1/C2 = 0.01^2 / 0.03^2)."""
    window = _gaussian_window(window_size, sigma)
    mu1 = _filter2d_separable(img1, window)
    mu2 = _filter2d_separable(img2, window)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2d_separable(img1 * img1, window) - mu1_sq
    sigma2_sq = _filter2d_separable(img2 * img2, window) - mu2_sq
    sigma12 = _filter2d_separable(img1 * img2, window) - mu12
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return torch.mean(ssim_map)


def photometric_loss(image, gt, lambda_dssim: float = 0.2):
    """((1-lambda) L1 + lambda (1-SSIM), L1)."""
    ll1 = l1_loss(image, gt)
    return (1.0 - lambda_dssim) * ll1 + lambda_dssim * (1.0 - ssim(image, gt)), ll1


def normal_consistency_loss(rend_normal, surf_normal):
    """mean(1 - <n_render, n_surf>) over pixels. Inputs (3,H,W)
    world-space; rend_normal is alpha-weighted (unnormalized)."""
    return torch.mean(1.0 - torch.sum(rend_normal * surf_normal, dim=0))


def distortion_loss(rend_dist):
    """Mean of the per-pixel accumulated distortion map."""
    return torch.mean(rend_dist)


def psnr(img1, img2):
    """Per-image PSNR from the MSE over the flattened CHW."""
    mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))
