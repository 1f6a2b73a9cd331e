"""Per-frame packs for the level kernel (torch port of the pack helpers in
phovo_tpu/ops/fused.py).

The packs hoist everything state-invariant out of the Gauss-Newton loop:
the back-projected source points with their depth-range mask, and the
target's intensity and gradients stacked so one pixel's three samples sit
at one (row, col) offset. The port computes at the exact pixel count
(N = H*W): the 128-lane padding and ceil8 row padding of the TPU layout
have no use on the GPU.
"""

from __future__ import annotations

import torch

from phovo_tpu_torch.ops.camera import Intrinsics


def pack_geometry(
    source_depth: torch.Tensor,  # (..., H, W) metres
    intr: Intrinsics,
    min_depth: float,
    max_depth: float,
) -> torch.Tensor:
    """(..., 4, H*W) rows [px, py, pz, valid_depth]: the back-projected
    source point and the open (min_depth, max_depth) range mask."""
    H, W = source_depth.shape[-2:]
    c = torch.arange(W, dtype=torch.float32, device=source_depth.device)
    r = torch.arange(H, dtype=torch.float32, device=source_depth.device)
    rr, cc = torch.meshgrid(r, c, indexing="ij")
    px = (cc - intr.cx) * source_depth / intr.fx
    py = (rr - intr.cy) * source_depth / intr.fy
    valid = ((source_depth > min_depth) & (source_depth < max_depth)).to(torch.float32)
    geom = torch.stack([px, py, source_depth, valid], dim=-3)
    return geom.reshape(*geom.shape[:-2], H * W)


def pack_target(
    target_intensity: torch.Tensor,
    target_grad_x: torch.Tensor,
    target_grad_y: torch.Tensor,
) -> torch.Tensor:
    """(..., 3, H, W) channel stack [I, gx, gy] of one target frame."""
    return torch.stack([target_intensity, target_grad_x, target_grad_y], dim=-3)
