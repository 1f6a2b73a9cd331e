"""Diagnostic images and map output (torch port of phovo_tpu/utils/viz.py).

The reference verifies an alignment by eye: |target - warped source|,
shown per frame and, with visualizeIterations, per iteration. Here the
same images are computed (alignment_diff, through the reference's
forward warp) and written as 8-bit grayscale PNGs by a writer of the
standard library (zlib and struct), the same on every machine: the card's
has no cv2.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np
import torch

from phovo_tpu_torch.models.base import DEFAULT_DEVICE
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.warp import forward_warp


def alignment_diff(
    source_intensity,
    source_depth,
    target_intensity,
    state,
    intr: Intrinsics,
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """|target - forward-warped source| as a float32 host array in the
    input intensity range, the warp computed on `device` (the CUDA card
    unless the caller names another). A converged alignment gives a
    near-black image (the reference's manual oracle)."""

    def on(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)

    warped = forward_warp(on(source_intensity), on(source_depth), on(state), intr).cpu().numpy()
    return np.abs(np.asarray(target_intensity, dtype=np.float32) - warped)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def save_image(path: str | Path, img: np.ndarray, unit_range: bool | None = None) -> None:
    """Write a (H, W) grayscale image as an 8-bit PNG; float arrays are
    clipped to [0, 255] and truncated.

    unit_range says whether a float input is in [0, 1] (scaled by 255) or
    already in [0, 255]. Pass it when you know the convention: the guess
    (max <= 1.5) inverts the "near-black means converged" oracle for a
    well-converged u8-range difference image, rendering every |diff| <=
    1.5 grey levels at full brightness."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        if unit_range is None:
            unit_range = arr.max() <= 1.5  # last-resort guess
        if unit_range:
            arr = arr * 255.0
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.ndim != 2:
        raise ValueError(f"save_image writes (H, W) grayscale images, got shape {arr.shape}")
    H, W = arr.shape
    # each row prefixed with filter type 0 (none)
    rows = np.concatenate([np.zeros((H, 1), np.uint8), arr], axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
           + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
           + _png_chunk(b"IEND", b""))
    Path(path).write_bytes(png)


def side_by_side(*images: np.ndarray, pad: int = 4) -> np.ndarray:
    """Horizontal float32 mosaic, images separated by `pad` columns of
    255; shorter images are padded with zeros at the bottom."""
    imgs = [np.asarray(i, dtype=np.float32) for i in images]
    H = max(i.shape[0] for i in imgs)
    sep = np.full((H, pad), 255.0, np.float32)
    cols = []
    for k, im in enumerate(imgs):
        if im.shape[0] < H:
            im = np.pad(im, ((0, H - im.shape[0]), (0, 0)))
        if k:
            cols.append(sep)
        cols.append(im)
    return np.concatenate(cols, axis=1)


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
