"""SSIM (port of diffpure_tpu/utils/ssim.py; ref mister_ed's pytorch_ssim):
Gaussian-window structural similarity over NHWC images, a depthwise
convolution per statistic. The window is symmetric, so ``F.conv2d``'s
correlation is JAX's convolution without a flip.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def gaussian_window(size: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(img1: Tensor, img2: Tensor, window_size: int = 11, sigma: float = 1.5,
         size_average: bool = True, data_range: float = 1.0) -> Tensor:
    """SSIM of NHWC images in [0, data_range]: the mean over everything
    (``size_average``), else per example."""
    C = img1.shape[-1]
    w = torch.from_numpy(gaussian_window(window_size, sigma)).to(img1.device, img1.dtype)
    w = w[None, None].expand(C, 1, window_size, window_size)
    pad = window_size // 2

    def filt(x: Tensor) -> Tensor:
        return F.conv2d(x.permute(0, 3, 1, 2), w, padding=pad, groups=C).permute(0, 2, 3, 1)

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = filt(img1 * img1) - mu1_sq
    sigma2_sq = filt(img2 * img2) - mu2_sq
    sigma12 = filt(img1 * img2) - mu12
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))
