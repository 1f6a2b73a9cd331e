"""Warping between RGB-D frames (torch port of phovo_tpu/ops/warp.py).

Residuals live at the SOURCE pixel and sample the target at the warped
coordinates (gather_warp, sample_*: the gather formulation the Jacobians
are consistent with). forward_warp is the reference's warpImage scatter,
used for the difference images only.
"""

from __future__ import annotations

import torch

from phovo_tpu_torch.ops import se3
from phovo_tpu_torch.ops.camera import Intrinsics, backproject, project

# |coordinate| clamp before a float -> int32 conversion: the CPU and CUDA
# convert out-of-range floats differently, a clamped one converts the same
# way on both and lands out of the image, as XLA's conversion does
_INT_CLAMP = 2.0**30


def transform_points(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply rigid transform T (4, 4) to points (..., 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return (R @ points.unsqueeze(-1)).squeeze(-1) + t


def warp_coordinates(depth: torch.Tensor, state: torch.Tensor, intr: Intrinsics):
    """Project every source pixel into the target frame: (col, row,
    transformed z), each (H, W). Invalid depths still give (garbage)
    coordinates, which callers mask; |z| is kept from 0 for the division."""
    tp = transform_points(backproject(depth, intr), se3.pose_matrix(state))
    z = tp[..., 2]
    safe = torch.where(torch.abs(z) > 1e-12, z, torch.full_like(z, 1e-12))
    col, row = project(torch.cat([tp[..., :2], safe[..., None]], dim=-1), intr)
    return col, row, z


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


def forward_warp(
    intensity: torch.Tensor,
    depth: torch.Tensor,
    state: torch.Tensor,
    intr: Intrinsics,
    level: int = 0,
) -> torch.Tensor:
    """The reference's warpImage: each source pixel's intensity written at
    its int-truncated projected pixel of the target frame, zeros where
    nothing lands (phovo_tpu/ops/warp.py::forward_warp). Where several
    source pixels land on one target pixel the later one (the largest
    source index, the reference's sequential loop) wins: each slot's winner
    is found with an amax scatter of source indices, which is
    deterministic on the CPU and on CUDA alike, and then gathered."""
    H, W = intensity.shape[-2:]
    col, row, _ = warp_coordinates(depth, state, intr.at_level(level))
    # truncation toward zero (static_cast<int>), not floor: a column in
    # (-1, 0) lands in column 0
    ci = col.clamp(-_INT_CLAMP, _INT_CLAMP).to(torch.int32)
    ri = row.clamp(-_INT_CLAMP, _INT_CLAMP).to(torch.int32)
    valid = (depth > 0) & (ri >= 0) & (ri < H) & (ci >= 0) & (ci < W)
    n = H * W
    idx = torch.where(valid, ri.to(torch.int64) * W + ci, torch.full_like(ri, n, dtype=torch.int64)).reshape(-1)
    src = torch.arange(n, dtype=torch.int64, device=intensity.device)
    winner = torch.full((n + 1,), -1, dtype=torch.int64, device=intensity.device)
    winner = winner.scatter_reduce(0, idx, src, reduce="amax")[:n]
    flat = intensity.reshape(-1)
    out = torch.where(winner >= 0, flat[winner.clamp(min=0)], torch.zeros((), dtype=flat.dtype, device=flat.device))
    return out.reshape(H, W)


def gather_warp(
    target: torch.Tensor,
    source_depth: torch.Tensor,
    state: torch.Tensor,
    intr: Intrinsics,
    level: int = 0,
    bilinear: bool = True,
):
    """Sample `target` at the projected coordinates of each source pixel:
    (warped target, valid), valid = source depth > 0, projected z > 0 and
    in bounds; invalid pixels read 0."""
    col, row, z = warp_coordinates(source_depth, state, intr.at_level(level))
    vals, inb = (sample_bilinear if bilinear else sample_nearest)(target, col, row)
    valid = (source_depth > 0) & (z > 0) & inb
    return torch.where(valid, vals, torch.zeros_like(vals)), valid
