"""Backend-independent alignment results and device-side input conversion
(torch port of the parts of phovo_tpu/models/base.py the frame chain runs).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class AlignmentResult(NamedTuple):
    """Per-pair alignment result with per-level diagnostics; batched results
    carry a leading pair dimension."""

    state: torch.Tensor  # (..., 6) [x, y, z, yaw, pitch, roll]
    iterations: torch.Tensor  # (..., L) int32 per level (level 0 first)
    gradient_norm: torch.Tensor  # (..., L) final ||J^T r||
    cost: torch.Tensor  # (..., L) final sum r^2
    num_valid: torch.Tensor  # (..., L) valid-pixel count
    # (..., L) pixels dropped by the TPU kernels' banded sampling window;
    # always 0 here, where the kernel samples the whole target
    band_masked: torch.Tensor


def device_unit_intensity(img: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 * (1/255) on the tensor's device (the reference
    SetSourceFrame conversion; a multiply, as phovo_tpu does, not a
    divide); float inputs pass through."""
    if img.dtype == torch.uint8:
        return img.to(torch.float32) * (1.0 / 255.0)
    return img


def chunk_device_prep(carry_intensity, carry_depth, intensities, depths, depth_scale):
    """Storage-dtype conversion and carry-frame prepend of the chunked
    sequence entry, on the device the tensors live on: per chunk the host
    moves only the new frames, in storage dtype (uint8 intensity, uint16
    depth counts times depth_scale); the carry frame stays on the device.
    Returns (I (B+1, H, W) float32, D (B+1, H, W) float32 metres)."""
    if depth_scale is not None and depths.dtype != torch.float32:
        depths = depths.to(torch.float32) * float(np.float32(depth_scale))
    intensities = device_unit_intensity(intensities).to(torch.float32)
    carry_f = device_unit_intensity(carry_intensity).to(torch.float32)
    I = torch.cat([carry_f[None], intensities])
    D = torch.cat([carry_depth.to(torch.float32)[None], depths])
    return I, D
