"""Image quality metrics (port of ``ssdnerf_tpu/core/metrics.py``):
``eval_psnr``, the Gaussian-window ``eval_ssim`` and the skimage /
pixelNeRF-convention ``eval_ssim_skimage`` (uniform 7x7 window, covariances
normalised by NP / (NP - 1)).

Each runs on its inputs' device and returns a (N,) tensor there.  The
separable 'valid' filters are two ``F.conv2d`` calls, run under
``unet.precision`` so that f32 convolutions are IEEE f32 on a card too.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..models.architecture.unet import precision


def eval_psnr(img1, img2, max_val=1.0, eps=1e-6):
    """(N, ...) -> (N,) PSNR of each item."""
    mse = torch.mean((img1 - img2) ** 2, dim=tuple(range(1, img1.dim())))
    return 10 * (2 * math.log10(max_val) - torch.log10(mse + eps))


def _gaussian_kernel(size, sigma):
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def _filter2d_separable(img, k):
    """img (N, C, H, W), k (S,) a separable kernel, 'valid' padding."""
    n, c, h, w = img.shape
    k = torch.as_tensor(k, dtype=img.dtype, device=img.device)
    x = img.reshape(n * c, 1, h, w)
    with precision():
        x = F.conv2d(x, k.reshape(1, 1, -1, 1))
        x = F.conv2d(x, k.reshape(1, 1, 1, -1))
    return x.reshape(n, c, x.shape[-2], x.shape[-1])


def eval_ssim(img1, img2, max_val=1.0, filter_size=11, filter_sigma=1.5,
              k1=0.01, k2=0.03):
    """Gaussian-window SSIM of NCHW images -> (N,) scores."""
    k = _gaussian_kernel(filter_size, filter_sigma)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu1 = _filter2d_separable(img1, k)
    mu2 = _filter2d_separable(img2, k)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2d_separable(img1 * img1, k) - mu1_sq
    sigma2_sq = _filter2d_separable(img2 * img2, k) - mu2_sq
    sigma12 = _filter2d_separable(img1 * img2, k) - mu12
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean(dim=(1, 2, 3))


def eval_ssim_skimage(img1, img2, data_range=1.0):
    """SSIM with skimage ``structural_similarity``'s defaults (uniform 7x7
    window, sample covariances) of NCHW images -> (N,) scores."""
    win = 7
    NP = win ** 2
    cov_norm = NP / (NP - 1)
    k = np.full(win, 1.0 / win, np.float32)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    ux = _filter2d_separable(img1, k)
    uy = _filter2d_separable(img2, k)
    uxx = _filter2d_separable(img1 * img1, k)
    uyy = _filter2d_separable(img2 * img2, k)
    uxy = _filter2d_separable(img1 * img2, k)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    ssim_map = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    return ssim_map.mean(dim=(1, 2, 3))
