"""Gather warping between RGB-D frames (torch port of phovo_tpu/ops/warp.py).

Residuals live at the SOURCE pixel and sample the target at the warped
coordinates (the gather formulation the Jacobians are consistent with).
"""

from __future__ import annotations

import torch


def transform_points(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply rigid transform T (4, 4) to points (..., 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return (R @ points.unsqueeze(-1)).squeeze(-1) + t


def _take(img: torch.Tensor, ri: torch.Tensor, ci: torch.Tensor):
    # callers clamp indices again after the float -> int conversion: a NaN
    # coordinate converts to an arbitrary integer
    H, W = img.shape[-2:]
    flat = img.reshape(*img.shape[:-2], H * W)
    return flat[..., ri * W + ci]


def sample_nearest(img: torch.Tensor, col: torch.Tensor, row: torch.Tensor):
    """Nearest sample of (..., H, W) at float (col, row): round half to
    even (torch.round, like jnp.round). Returns (values, in_bounds);
    out-of-bounds reads are clamped, mask them with in_bounds."""
    H, W = img.shape[-2:]
    rr = torch.round(row)
    cc = torch.round(col)
    inb = (rr >= 0) & (rr <= H - 1) & (cc >= 0) & (cc <= W - 1)
    ri = torch.clamp(rr, 0, H - 1).to(torch.int64).clamp_(0, H - 1)
    ci = torch.clamp(cc, 0, W - 1).to(torch.int64).clamp_(0, W - 1)
    return _take(img, ri, ci), inb


def sample_bilinear(img: torch.Tensor, col: torch.Tensor, row: torch.Tensor):
    """Bilinear sample at (col, row). In-bounds is the continuous test
    0 <= coord < size; the +1 taps clamp to the last row/column (no zero
    padding)."""
    H, W = img.shape[-2:]
    inb = (row >= 0) & (row < H) & (col >= 0) & (col < W)
    r0 = torch.floor(row)
    c0 = torch.floor(col)
    wr = row - r0
    wc = col - c0
    r0i = torch.clamp(r0, 0, H - 1).to(torch.int64).clamp_(0, H - 1)
    c0i = torch.clamp(c0, 0, W - 1).to(torch.int64).clamp_(0, W - 1)
    r1i = torch.clamp(r0i + 1, max=H - 1)
    c1i = torch.clamp(c0i + 1, max=W - 1)
    top = _take(img, r0i, c0i) * (1 - wc) + _take(img, r0i, c1i) * wc
    bot = _take(img, r1i, c0i) * (1 - wc) + _take(img, r1i, c1i) * wc
    return top * (1 - wr) + bot * wr, inb
