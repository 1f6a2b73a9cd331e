"""Synthetic RGB-D frames with exact ground-truth pose (numpy; a jax-free
copy of the generators of phovo_tpu/utils/synthetic.py that the frame
chain needs).

An analytically textured slanted plane is rendered from known camera
poses, so alignment must recover a KNOWN state. Poses here are computed in
float64 (phovo_tpu rounds them through float32), so frames from the two
packages agree to about 1e-7; tests feed both packages the same arrays.
"""

from __future__ import annotations

import numpy as np

from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.se3 import pose_matrix_np


def _texture(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Smooth, non-periodic-looking intensity in [0, 1] over plane coords."""
    v = (
        0.5
        + 0.18 * np.sin(3.1 * x) * np.cos(2.3 * y)
        + 0.12 * np.sin(7.3 * x + 1.1)
        + 0.10 * np.cos(5.7 * y + 0.4)
        + 0.10 * np.sin(2.1 * (x + y))
    )
    return np.clip(v, 0.0, 1.0)


def render_plane(
    intr: Intrinsics,
    shape: tuple[int, int],
    T_cam_from_world: np.ndarray,
    plane_normal=(0.06, -0.04, 1.0),
    plane_d: float = 2.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Render float32 (intensity, depth) of the textured plane n.p = d
    (world frame) from a camera with pose T (world -> camera)."""
    H, W = shape
    fx, fy, cx, cy = (float(v) for v in intr)
    n = np.asarray(plane_normal, dtype=np.float64)
    R = np.asarray(T_cam_from_world, dtype=np.float64)[:3, :3]
    t = np.asarray(T_cam_from_world, dtype=np.float64)[:3, 3]
    # plane in the camera frame: (R n).p_c = d + (R n).t
    n_c = R @ n
    d_c = plane_d + n_c @ t
    cc, rr = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    vx = (cc - cx) / fx
    vy = (rr - cy) / fy
    z = d_c / np.maximum(n_c[0] * vx + n_c[1] * vy + n_c[2], 1e-9)
    pc = np.stack([vx * z, vy * z, z], axis=-1)
    pw = (pc - t) @ R  # R^T (p - t), row-wise
    return _texture(pw[..., 0], pw[..., 1]).astype(np.float32), z.astype(np.float32)


def smooth_trajectory(
    n_frames: int, motion_scale: float = 1.0, seed: int = 0
) -> list[np.ndarray]:
    """Smooth handheld-like camera path (list of T_cam_from_world, first =
    identity): sinusoidal sway with a fixed 60-frame period, ~1.3 cm and
    ~0.3 deg per frame at motion_scale 1, phases drawn from `seed`."""
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0, 2 * np.pi, 6)
    amp_t = np.array([0.12, 0.08, 0.10]) * motion_scale
    amp_r = np.array([0.05, 0.04, 0.06]) * motion_scale
    poses = []
    for k in range(n_frames):
        u = 2 * np.pi * k / 60.0
        state = np.concatenate([
            amp_t * np.sin(u + phase[:3]) - amp_t * np.sin(phase[:3]),
            amp_r * np.sin(u + phase[3:]) - amp_r * np.sin(phase[3:]),
        ])
        poses.append(pose_matrix_np(state))
    return poses


def make_sequence(
    intr: Intrinsics,
    shape: tuple[int, int] = (480, 640),
    n_frames: int = 30,
    motion_scale: float = 1.0,
    seed: int = 0,
):
    """Synthetic RGB-D sequence along smooth_trajectory. Returns
    (intensities, depths, gt world_from_cam poses, timestamps at 30 Hz);
    the gt poses are what integrating pose <- pose @ Rt^-1 reproduces."""
    intensities, depths, gts = [], [], []
    for T in smooth_trajectory(n_frames, motion_scale, seed):
        I, D = render_plane(intr, shape, T)
        intensities.append(I)
        depths.append(D)
        gts.append(np.linalg.inv(T))
    return intensities, depths, gts, np.arange(n_frames, dtype=np.float64) / 30.0


def make_pair(
    intr: Intrinsics,
    shape: tuple[int, int] = (480, 640),
    state: np.ndarray | None = None,
):
    """(I0, D0, I1, D1, gt_state): pose_matrix(gt_state) takes source
    (frame 0) camera points into the target (frame 1) camera frame."""
    if state is None:
        state = np.array([0.02, -0.015, 0.01, 0.008, -0.006, 0.01], dtype=np.float32)
    state = np.asarray(state, dtype=np.float32)
    I0, D0 = render_plane(intr, shape, np.eye(4))
    I1, D1 = render_plane(intr, shape, pose_matrix_np(state))
    return I0, D0, I1, D1, state
