"""Map output (torch port of phovo_tpu/utils/viz.py's save_ply; the
difference-image diagnostics wait for ROADMAP.md queue A, item 12)."""

from __future__ import annotations

import numpy as np


def save_ply(path, points, intensity=None) -> None:
    """Write a sparse landmark map as an ASCII PLY point cloud: points (N,
    3) in world coordinates, intensity (N,) in 0..1 as a grey vertex
    colour. The keyframe back-end's bundle-adjusted landmarks
    (KeyframeVisualOdometry.map_points) are such a map."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    n = len(pts)
    lines = ["ply", "format ascii 1.0", f"element vertex {n}", "property float x", "property float y",
             "property float z"]
    if intensity is not None:
        g = np.clip(np.asarray(intensity, np.float64).reshape(-1), 0.0, 1.0)
        g = (g * 255.0 + 0.5).astype(np.uint8)
        lines += ["property uchar red", "property uchar green", "property uchar blue"]
    lines.append("end_header")
    for k in range(n):
        row = f"{pts[k, 0]:.6f} {pts[k, 1]:.6f} {pts[k, 2]:.6f}"
        if intensity is not None:
            row += f" {g[k]} {g[k]} {g[k]}"
        lines.append(row)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
