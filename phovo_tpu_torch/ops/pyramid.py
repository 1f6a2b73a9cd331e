"""Image pyramids, Gaussian/box blur and Scharr gradients (torch port of
phovo_tpu/ops/pyramid.py).

Reference behaviour matched: level k is the ORIGINAL image resized by
1/2^k with cv::resize INTER_LINEAR, then (intensity only) blurred twice
when a blur size is configured; Scharr d/dx, d/dy per level with a
per-level scale; every border is BORDER_REFLECT_101, which is what
F.pad(mode="reflect") does. Filters are separable shifted adds, so they
never go through cuDNN (whose float32 convolutions default to TF32).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def level_shape(shape: tuple[int, int], level: int) -> tuple[int, int]:
    """Output (H, W) of cv::resize(src, Size(0, 0), f, f), f = 1/2^level
    (Python round, as phovo_tpu does)."""
    f = 1.0 / (2.0**level)
    return (int(round(shape[0] * f)), int(round(shape[1] * f)))


@functools.lru_cache(maxsize=None)
def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear operator along one axis, OpenCV INTER_LINEAR
    coordinates src = (dst + 0.5) * n_in / n_out - 0.5, edge-clamped."""
    A = np.zeros((n_out, n_in), dtype=np.float32)
    scale = n_in / n_out
    for d in range(n_out):
        s = (d + 0.5) * scale - 0.5
        s0 = math.floor(s)
        w1 = s - s0
        A[d, min(max(s0, 0), n_in - 1)] += 1.0 - w1
        A[d, min(max(s0 + 1, 0), n_in - 1)] += w1
    return A


def _gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel: exp(-(i-c)^2 / (2 sigma^2)), normalized."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    c = (ksize - 1) * 0.5
    i = np.arange(ksize, dtype=np.float64)
    k = np.exp(-((i - c) ** 2) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _pow2_factor(n_in: int, n_out: int) -> int | None:
    """k such that n_in == n_out * 2^k (exact power-of-two downscale)."""
    if n_out <= 0 or n_in % n_out:
        return None
    q = n_in // n_out
    return q.bit_length() - 1 if q & (q - 1) == 0 and q > 1 else None


def resize_bilinear(img: torch.Tensor, out_shape: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W) to (..., H', W').

    For an exact 1/2^k downscale every output is the mean of two adjacent
    pixels at stride 2^k (the source coordinate always has fraction 0.5):
    strided slices and adds. Other shapes use the banded operator matrices,
    Ar @ img @ Ac^T."""
    H, W = img.shape[-2:]
    Ho, Wo = out_shape
    if (H, W) == (Ho, Wo):
        return img
    kr = _pow2_factor(H, Ho)
    kc = _pow2_factor(W, Wo)
    if kr is not None and kc is not None:
        sr, sc = 1 << kr, 1 << kc
        offr, offc = sr // 2 - 1, sc // 2 - 1
        rows_a = img[..., offr::sr, :][..., :Ho, :]
        rows_b = img[..., offr + 1 :: sr, :][..., :Ho, :]
        rows = 0.5 * (rows_a + rows_b)
        cols_a = rows[..., offc::sc][..., :Wo]
        cols_b = rows[..., offc + 1 :: sc][..., :Wo]
        return 0.5 * (cols_a + cols_b)
    Ar = torch.from_numpy(resize_matrix(H, Ho)).to(img.device)
    Ac = torch.from_numpy(resize_matrix(W, Wo)).to(img.device)
    return Ar @ img @ Ac.T


def _reflect_pad(img: torch.Tensor, dim: int, before: int, after: int):
    """Reflect-101 padding of one of the two trailing dims of (..., H, W)."""
    lead = img.shape[:-2]
    x = img.reshape(-1, 1, *img.shape[-2:])
    pad = (0, 0, before, after) if dim == -2 else (before, after, 0, 0)
    x = F.pad(x, pad, mode="reflect")
    return x.reshape(*lead, *x.shape[-2:])


def _sep_filter(img: torch.Tensor, kr, kc) -> torch.Tensor:
    """Separable correlation with reflect-101 borders via shifted adds.
    The anchor is OpenCV's ksize // 2 (one right of centre for even
    kernels, which cv::blur accepts)."""
    ar, ac = len(kr) // 2, len(kc) // 2
    out = img
    if len(kr) > 1:
        p = _reflect_pad(out, -2, ar, len(kr) - 1 - ar)
        H = img.shape[-2]
        out = sum(float(kr[t]) * p[..., t : t + H, :] for t in range(len(kr)))
    if len(kc) > 1:
        p = _reflect_pad(out, -1, ac, len(kc) - 1 - ac)
        W = img.shape[-1]
        out = sum(float(kc[t]) * p[..., t : t + W] for t in range(len(kc)))
    return out


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float = 3.0) -> torch.Tensor:
    """Separable Gaussian blur with reflect-101 borders (one pass)."""
    if ksize <= 0:
        return img
    k = _gaussian_kernel_1d(ksize, sigma)
    return _sep_filter(img, k, k)


def box_blur(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Normalized box filter with reflect-101 borders (cv::blur)."""
    if ksize <= 0:
        return img
    k = np.full(ksize, 1.0 / ksize, dtype=np.float64)
    return _sep_filter(img, k, k)


def scharr(img: torch.Tensor, axis: str, scale: float = 1.0) -> torch.Tensor:
    """Scharr gradient of (..., H, W): axis 'x' is d/dcol, 'y' d/drow."""
    deriv = [-1.0, 0.0, 1.0]
    smooth = [3.0, 10.0, 3.0]
    if axis == "x":
        out = _sep_filter(img, smooth, deriv)
    elif axis == "y":
        out = _sep_filter(img, deriv, smooth)
    else:
        raise ValueError(f"axis must be 'x' or 'y', got {axis!r}")
    return out * float(np.float32(scale))


def build_pyramid(
    img: torch.Tensor,
    num_levels: int,
    blur_filter_sizes=None,
    blur_sigma: float = 3.0,
    blur_type: str = "gaussian",
) -> list[torch.Tensor]:
    """Per-level images, level 0 = full resolution. Each level is resized
    from the ORIGINAL image, then blurred twice (gaussian, sigma 3, or box)
    when its blur size is positive."""
    if blur_type not in ("gaussian", "box"):
        raise ValueError(f"blur_type={blur_type!r}; expected 'gaussian' or 'box'")
    base_shape = img.shape[-2:]
    pyramid = []
    for level in range(num_levels):
        lvl = resize_bilinear(img, level_shape(base_shape, level))
        k = int(blur_filter_sizes[level]) if blur_filter_sizes is not None else 0
        if k > 0:
            if blur_type == "box":
                lvl = box_blur(box_blur(lvl, k), k)
            else:
                lvl = gaussian_blur(gaussian_blur(lvl, k, blur_sigma), k, blur_sigma)
        pyramid.append(lvl)
    return pyramid


def build_gradient_pyramid(pyramid, scales):
    """Per-level (d/dx, d/dy) Scharr gradients with per-level scaling."""
    gx = [scharr(img, "x", scales[i]) for i, img in enumerate(pyramid)]
    gy = [scharr(img, "y", scales[i]) for i, img in enumerate(pyramid)]
    return gx, gy
