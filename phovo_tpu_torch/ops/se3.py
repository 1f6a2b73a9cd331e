"""SE(3) pose parameterization (torch port of phovo_tpu/ops/se3.py).

state = [x, y, z, yaw, pitch, roll] with R = Rz(yaw) Ry(pitch) Rx(roll)
(ZYX intrinsic Euler, the reference's convention). Tensor functions take
any leading batch dims; the *_np twins run on the host in float64.
"""

from __future__ import annotations

import numpy as np
import torch


def _zyx_rows(x, y, z, yaw, pitch, roll, cos, sin, zeros, ones):
    cy, sy = cos(yaw), sin(yaw)
    cp, sp = cos(pitch), sin(pitch)
    cr, sr = cos(roll), sin(roll)
    return [
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr, x],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr, y],
        [-sp, cp * sr, cp * cr, z],
        [zeros(x), zeros(x), zeros(x), ones(x)],
    ]


def pose_matrix(state: torch.Tensor) -> torch.Tensor:
    """(..., 6) state -> (..., 4, 4) rigid transform."""
    rows = _zyx_rows(
        *state.unbind(-1), torch.cos, torch.sin, torch.zeros_like,
        torch.ones_like,
    )
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotation_zyx(yaw: torch.Tensor, pitch: torch.Tensor, roll: torch.Tensor) -> torch.Tensor:
    """(...,) angles -> (..., 3, 3) rotation R = Rz(yaw) Ry(pitch) Rx(roll)."""
    rows = _zyx_rows(
        torch.zeros_like(yaw), torch.zeros_like(yaw), torch.zeros_like(yaw), yaw, pitch, roll,
        torch.cos, torch.sin, torch.zeros_like, torch.ones_like,
    )
    return torch.stack([torch.stack(r[:3], dim=-1) for r in rows[:3]], dim=-2)


def pose_matrix_np(state) -> np.ndarray:
    """Host-side float64 twin of pose_matrix."""
    state = np.asarray(state, np.float64)
    rows = _zyx_rows(
        *np.moveaxis(state, -1, 0), np.cos, np.sin, np.zeros_like,
        np.ones_like,
    )
    return np.stack([np.stack(r, axis=-1) for r in rows], axis=-2)


def matrix_to_state_np(T) -> np.ndarray:
    """Host-side float64 twin of matrix_to_state (any leading dims)."""
    T = np.asarray(T, np.float64)
    R = T[..., :3, :3]
    pitch = np.arcsin(np.clip(-R[..., 2, 0], -1.0, 1.0))
    yaw = np.arctan2(R[..., 1, 0], R[..., 0, 0])
    roll = np.arctan2(R[..., 2, 1], R[..., 2, 2])
    return np.concatenate([T[..., :3, 3], np.stack([yaw, pitch, roll], axis=-1)], axis=-1)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform (batched)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    top = torch.cat([Rt, -Rt @ T[..., :3, 3:]], dim=-1)
    bottom = torch.zeros_like(T[..., 3:, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for rigid transforms (batched matmul)."""
    return A @ B


def integrate_trajectory(states: torch.Tensor) -> torch.Tensor:
    """(..., B, 6) relative states (pair k aligns frame k -> k+1) -> (...,
    B, 4, 4) global poses pose_k = inv(Rt_0) @ ... @ inv(Rt_k): the VO
    app's running pose <- pose @ Rt^-1 from identity, as a log-depth prefix
    product (Hillis-Steele scan: ceil(log2 B) batched matmuls); leading
    dims are independent trajectories."""
    M = inverse(pose_matrix(states))
    step = 1
    while step < M.shape[-3]:
        M = torch.cat([M[..., :step, :, :], M[..., :-step, :, :] @ M[..., step:, :, :]], dim=-3)
        step *= 2
    return M


def matrix_to_state(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) rigid transform -> (..., 6) state (inverse of
    pose_matrix; pitch on the principal branch)."""
    R = T[..., :3, :3]
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.cat(
        [T[..., :3, 3], torch.stack([yaw, pitch, roll], dim=-1)], dim=-1
    )


def rotation_jacobian_wrt_euler(state: torch.Tensor) -> torch.Tensor:
    """(..., 6) state -> (..., 3, 3, 3) with [..., k] = dR/d(angle_k) for
    angles (yaw, pitch, roll)."""
    _, _, _, yaw, pitch, roll = state.unbind(-1)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    z = torch.zeros_like(yaw)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    d_yaw = mat([
        [-sy * cp, -sy * sp * sr - cy * cr, -sy * sp * cr + cy * sr],
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [z, z, z],
    ])
    d_pitch = mat([
        [-cy * sp, cy * cp * sr, cy * cp * cr],
        [-sy * sp, sy * cp * sr, sy * cp * cr],
        [-cp, -sp * sr, -sp * cr],
    ])
    d_roll = mat([
        [z, cy * sp * cr + sy * sr, -cy * sp * sr + sy * cr],
        [z, sy * sp * cr - cy * sr, -sy * sp * sr - cy * cr],
        [z, cp * cr, -cp * sr],
    ])
    return torch.stack([d_yaw, d_pitch, d_roll], dim=-3)


def _shepperd(R, sqrt, maximum, stack, where, norm):
    """Branchless Shepperd selection of the unit quaternion [qx, qy, qz,
    qw] of (..., 3, 3) rotations: all four candidates are computed and the
    numerically best one kept, normalized to qw >= 0 (the trajectory
    writer's convention). Shared by the tensor and the numpy forms."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(v):
        return sqrt(maximum(v, 1e-24))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3], -1)
    cond_tr = (tr > 0.0)[..., None]
    cond_1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond_2 = (m11 > m22)[..., None]
    q = where(cond_tr, q0, where(cond_1, q1, where(cond_2, q2, q3)))
    q = q / norm(q)
    return where(q[..., 3:4] < 0, -q, q)


def rotation_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 4) unit quaternion [qx, qy, qz, qw]
    (phovo_tpu/ops/se3.py::rotation_to_quaternion), qw >= 0."""
    return _shepperd(
        R, torch.sqrt, lambda v, lo: torch.clamp(v, min=lo), torch.stack, torch.where,
        lambda q: torch.linalg.norm(q, dim=-1, keepdim=True),
    )


def rotation_to_quaternion_np(R) -> np.ndarray:
    """Host-side float64 twin of rotation_to_quaternion."""
    return _shepperd(
        np.asarray(R, np.float64), np.sqrt, np.maximum, np.stack, np.where,
        lambda q: np.linalg.norm(q, axis=-1, keepdims=True),
    )


def _quaternion_rows(q, unbind):
    qx, qy, qz, qw = unbind(q)
    return [
        [1 - 2 * (qy**2 + qz**2), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx**2 + qz**2), 2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx**2 + qy**2)],
    ]


def quaternion_to_rotation(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) unit quaternion [qx, qy, qz, qw] -> (..., 3, 3) rotation."""
    rows = _quaternion_rows(q, lambda v: v.unbind(-1))
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quaternion_to_rotation_np(q) -> np.ndarray:
    """Host-side float64 twin of quaternion_to_rotation."""
    rows = _quaternion_rows(np.asarray(q, np.float64), lambda v: np.moveaxis(v, -1, 0))
    return np.stack([np.stack(r, axis=-1) for r in rows], axis=-2)
