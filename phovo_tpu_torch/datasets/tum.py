"""TUM RGB-D frame record (torch port of phovo_tpu/datasets/tum.py's
RGBDFrame). The readers of TUM sequence directories are not ported yet
(ROADMAP.md queue A, item 3); the keyframe tracker takes any iterable of
these records."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RGBDFrame:
    timestamp: float  # intensity timestamp (the one the reference writes)
    depth_timestamp: float
    intensity: np.ndarray  # (H, W) uint8 grayscale
    depth: np.ndarray  # (H, W) float32 metres (0 = invalid), or uint16 counts
