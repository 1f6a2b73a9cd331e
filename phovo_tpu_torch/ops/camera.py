"""Pinhole camera intrinsics with pyramid-level scaling (torch port of
phovo_tpu/ops/camera.py).

Intrinsics hold plain Python floats: they are per-sequence constants that
the kernels take as scalar arguments. Level scaling keeps the reference
convention fx, fy, cx, cy all divided by 2^level (cx/2^level, not the
half-pixel-centre-preserving (cx + 0.5)/2^level - 0.5).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Intrinsics(NamedTuple):
    """Pinhole intrinsics as Python floats."""

    fx: float
    fy: float
    cx: float
    cy: float

    @staticmethod
    def from_matrix(K) -> "Intrinsics":
        """(3, 3) camera matrix (numpy or nested lists) -> Intrinsics. The
        entries are rounded to float32 first, the precision every kernel
        computes in."""
        K = np.asarray(K, dtype=np.float32)
        return Intrinsics(
            float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])
        )

    def matrix(self) -> torch.Tensor:
        """The (3, 3) float32 camera matrix [fx 0 cx; 0 fy cy; 0 0 1], on
        the CPU (phovo_tpu/ops/camera.py::Intrinsics.matrix)."""
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]], dtype=torch.float32
        )

    def at_level(self, level: int) -> "Intrinsics":
        s = 1.0 / (2.0**level)
        return Intrinsics(self.fx * s, self.fy * s, self.cx * s, self.cy * s)


def _f32(v: float) -> float:
    return float(np.float32(v))


# TUM RGB-D intrinsics hardcoded in the reference apps, rounded to float32
# exactly as phovo_tpu stores them: fr1 (PhotoconsistencyVisualOdometry.cpp)
TUM_FR1 = Intrinsics(_f32(517.3), _f32(516.5), _f32(318.6), _f32(255.3))
# default/kinect (PhotoconsistencyFrameAlignment.cpp)
TUM_DEFAULT = Intrinsics(_f32(525.0), _f32(525.0), _f32(319.5), _f32(239.5))
# fr2 and fr3 (the TUM benchmark's calibrations, as phovo_tpu has them)
TUM_FR2 = Intrinsics(_f32(520.9), _f32(521.0), _f32(325.1), _f32(249.7))
TUM_FR3 = Intrinsics(_f32(535.4), _f32(539.2), _f32(320.1), _f32(247.6))

# the CLIs' --intrinsics presets
NAMED_INTRINSICS = {"fr1": TUM_FR1, "fr2": TUM_FR2, "fr3": TUM_FR3, "default": TUM_DEFAULT}


def backproject(depth: torch.Tensor, intr: Intrinsics, row_offset: float = 0.0) -> torch.Tensor:
    """Depth image (..., H, W) -> camera-frame points (..., H, W, 3).

    x = (c - cx) z / fx, y = (r - cy) z / fy (columns are x, rows are y).
    row_offset: the global row of local row 0, where the image is a block
    of rows of a frame split over ranks (parallel/sharded_ne.py)."""
    H, W = depth.shape[-2:]
    c = torch.arange(W, dtype=depth.dtype, device=depth.device)
    r = torch.arange(H, dtype=depth.dtype, device=depth.device) + row_offset
    rr, cc = torch.meshgrid(r, c, indexing="ij")
    x = (cc - intr.cx) * depth / intr.fx
    y = (rr - intr.cy) * depth / intr.fy
    return torch.stack([x, y, depth], dim=-1)


def project(points: torch.Tensor, intr: Intrinsics):
    """Camera-frame points (..., 3) -> pixel coords (col, row)."""
    inv_z = 1.0 / points[..., 2]
    col = points[..., 0] * intr.fx * inv_z + intr.cx
    row = points[..., 1] * intr.fy * inv_z + intr.cy
    return col, row
