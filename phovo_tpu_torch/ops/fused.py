"""Per-frame packs for the level kernels (torch port of the pack helpers in
phovo_tpu/ops/fused.py), and the per-pair trust-region level.

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
from phovo_tpu_torch.ops.fused_batch import fused_tr_level_batch


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


def fused_tr_level(
    source_intensity: torch.Tensor,  # (H, W)
    source_depth: torch.Tensor,  # (H, W) metres
    t_all: torch.Tensor,  # (3, H, W) pack_target of the target frame
    intr: Intrinsics,  # at this level
    init_state: torch.Tensor,  # (6,)
    min_depth: float,
    max_depth: float,
    opts,  # solvers.trust_region.TROptions
    sampling: str = "bilinear",
):
    """One whole trust-region LM level for one pair (torch port of
    phovo_tpu/ops/fused.py::fused_tr_level): the pair is packed and run
    through the batched level (ops/fused_batch.fused_tr_level_batch) with
    B = 1, the CUDA kernel for CUDA tensors and its plain version for CPU
    tensors. Returns (state (6,), iterations, cost, gradient_norm, radius,
    num_valid, band_masked) in solvers.trust_region.TRLevelResult's order."""
    H, W = source_intensity.shape
    res = fused_tr_level_batch(
        source_intensity.reshape(1, H * W).contiguous(),
        pack_geometry(source_depth, intr, min_depth, max_depth)[None].contiguous(),
        t_all[None].contiguous(),
        intr,
        init_state.to(torch.float32).reshape(1, 6).contiguous(),
        opts, H=H, W=W, sampling=sampling,
    )
    return tuple(x[0] for x in res)
