"""Image metrics: MSE, PSNR, SSIM (port of ``keras_nerf_tpu/ops/metrics.py``).

``tf.image.psnr`` and ``tf.image.ssim`` with ``max_val=1`` and TF's
defaults (11 x 11 Gaussian window, sigma 1.5, k1 0.01, k2 0.03), as the
reference training loop uses them (`keras_nerf/model/nerf/nerf.py:306-330`).

The Gaussian blur is separable and VALID: eleven shifted, weighted float32
slices per axis. It runs no convolution, so cuDNN's TF32 default never
touches it and the ``sigma^2 = blur(x^2) - mu^2`` cancellation keeps full
float32 precision on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Global mean squared error (a 0-d tensor)."""
    return torch.mean(torch.square(pred - target))


def psnr(pred: torch.Tensor, target: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """Per-image PSNR over ``[B, H, W, C]`` -> ``[B]``."""
    err = torch.mean(torch.square(pred - target),
                     dim=tuple(range(1, pred.ndim)))
    return 10.0 * (np.log10(max_val ** 2) - torch.log10(err))


@functools.lru_cache(maxsize=None)
def _gaussian_window(filter_size: int, filter_sigma: float) -> tuple:
    """Normalized 1-D Gaussian, as float32 Python floats (tf's fspecial)."""
    coords = np.arange(filter_size, dtype=np.float64) - (filter_size - 1) / 2
    g = np.exp(-(coords ** 2) / (2.0 * filter_sigma ** 2))
    return tuple(float(v) for v in (g / g.sum()).astype(np.float32))


def _blur(x: torch.Tensor, window: tuple) -> torch.Tensor:
    """VALID separable blur of ``[B, H, W, C]`` along H, then W."""
    k = len(window)
    for dim in (1, 2):
        n = x.shape[dim] - k + 1
        out = window[0] * x.narrow(dim, 0, n)
        for i in range(1, k):
            out = out + window[i] * x.narrow(dim, i, n)
        x = out
    return x


def ssim(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 1.0,
         filter_size: int = 11, filter_sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Per-image SSIM over ``[B, H, W, C]`` -> ``[B]``: biased moments,
    luminance times contrast-structure, averaged over space and channels.
    Images smaller than the window clamp it to ``min(11, H, W)``, as the
    JAX package does."""
    filter_size = min(filter_size, img1.shape[1], img1.shape[2])
    window = _gaussian_window(filter_size, filter_sigma)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu1 = _blur(img1, window)
    mu2 = _blur(img2, window)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    sigma1_sq = _blur(img1 * img1, window) - mu1_sq
    sigma2_sq = _blur(img2 * img2, window) - mu2_sq
    sigma12 = _blur(img1 * img2, window) - mu12
    luminance = (2.0 * mu12 + c1) / (mu1_sq + mu2_sq + c1)
    cs = (2.0 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    return torch.mean(luminance * cs, dim=tuple(range(1, img1.ndim)))
