"""Trajectories in TUM format ('timestamp tx ty tz qx qy qz qw'), their
reader and writer, and the absolute and relative pose errors (numpy; a
jax-free copy of phovo_tpu/utils/trajectory.py, with the TUM
evaluate_ate.py and evaluate_rpe.py semantics).
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np

from phovo_tpu_torch.ops.se3 import quaternion_to_rotation_np, rotation_to_quaternion_np


class Trajectory(NamedTuple):
    timestamps: np.ndarray  # (N,)
    positions: np.ndarray  # (N, 3)
    quaternions: np.ndarray  # (N, 4) [qx, qy, qz, qw]

    def __len__(self) -> int:
        return len(self.timestamps)

    def pose_matrix(self, i: int) -> np.ndarray:
        """Pose i as a (4, 4) float64 world_from_cam matrix."""
        T = np.eye(4)
        T[:3, :3] = quaternion_to_rotation_np(self.quaternions[i])
        T[:3, 3] = self.positions[i]
        return T

    @staticmethod
    def from_poses(timestamps, poses) -> "Trajectory":
        """Trajectory from (N, 4, 4) world_from_cam poses."""
        poses = np.asarray(poses, np.float64)
        return Trajectory(
            np.asarray(timestamps, np.float64), poses[:, :3, 3],
            rotation_to_quaternion_np(poses[:, :3, :3]),
        )


def format_pose_line(timestamp: float, T: np.ndarray) -> str:
    """One TUM trajectory line 'timestamp tx ty tz qx qy qz qw' from a 4x4
    pose (16-significant-digit timestamps, as the reference writes)."""
    q = rotation_to_quaternion_np(np.asarray(T[:3, :3], dtype=np.float64))
    t = T[:3, 3]
    return (
        f"{timestamp:.16g} {t[0]:.9g} {t[1]:.9g} {t[2]:.9g} "
        f"{q[0]:.9g} {q[1]:.9g} {q[2]:.9g} {q[3]:.9g}"
    )


class TrajectoryWriter:
    """Streams TUM-format lines under a two-line header, one flushed line
    a pose, so a run cut short keeps the poses written before the cut.
    append=True continues a file (the header only if it is empty)."""

    def __init__(self, path: str | Path, append: bool = False):
        self._f = open(path, "a" if append else "w")
        if not append or self._f.tell() == 0:
            self._f.write("# estimated trajectory\n")
            self._f.write("# timestamp tx ty tz qx qy qz qw\n")

    def write(self, timestamp: float, T: np.ndarray) -> None:
        self._f.write(format_pose_line(timestamp, T) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_trajectory(path: str | Path) -> Trajectory:
    """A TUM-format trajectory file: '#' comments and lines of fewer than
    eight numbers skipped."""
    ts, pos, quat = [], [], []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        v = [float(x) for x in line.split()]
        if len(v) < 8:
            continue
        ts.append(v[0])
        pos.append(v[1:4])
        quat.append(v[4:8])
    return Trajectory(np.asarray(ts), np.asarray(pos), np.asarray(quat))


def associate_timestamps(ta, tb, max_dt: float = 0.02):
    """Greedy timestamp association (TUM associate.py): every pair with
    |ta_i - tb_j| <= max_dt is a candidate; candidates are claimed closest
    first, each index once. Returns (ia, ib) sorted by ia."""
    ta = np.asarray(ta, np.float64)
    tb = np.asarray(tb, np.float64)
    order_b = np.argsort(tb, kind="stable")
    tbs = tb[order_b]
    lo = np.searchsorted(tbs, ta - max_dt, side="left")
    hi = np.searchsorted(tbs, ta + max_dt, side="right")
    counts = hi - lo
    if int(counts.sum()) == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    i_idx = np.repeat(np.arange(len(ta)), counts)
    starts = np.repeat(lo, counts)
    offs = np.arange(len(i_idx)) - np.repeat(np.cumsum(counts) - counts, counts)
    j_idx = order_b[starts + offs]
    dt = np.abs(ta[i_idx] - tb[j_idx])
    used_a = np.zeros(len(ta), bool)
    used_b = np.zeros(len(tb), bool)
    ia, ib = [], []
    for k in np.lexsort((j_idx, i_idx, dt)):
        i, j = i_idx[k], j_idx[k]
        if not used_a[i] and not used_b[j]:
            used_a[i] = used_b[j] = True
            ia.append(i)
            ib.append(j)
    order = np.argsort(ia)
    return np.asarray(ia, np.int64)[order], np.asarray(ib, np.int64)[order]


def horn_align(model: np.ndarray, data: np.ndarray):
    """Closed-form rigid alignment (Horn 1987, as TUM evaluate_ate.py):
    (R, t) minimizing ||R @ model + t - data||, no scale."""
    mu_m = model.mean(axis=0)
    mu_d = data.mean(axis=0)
    U, _, Vt = np.linalg.svd((model - mu_m).T @ (data - mu_d))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = Vt.T @ S @ U.T
    return R, mu_d - R @ mu_m


def absolute_trajectory_error(
    estimated: Trajectory, ground_truth: Trajectory, max_dt: float = 0.02
) -> dict:
    """ATE after timestamp association and Horn alignment."""
    ie, ig = associate_timestamps(estimated.timestamps, ground_truth.timestamps, max_dt)
    if len(ie) < 2:
        raise ValueError("fewer than 2 associated poses between trajectories")
    P = estimated.positions[ie]
    Q = ground_truth.positions[ig]
    R, t = horn_align(P, Q)
    norms = np.linalg.norm((P @ R.T + t) - Q, axis=1)
    return {
        "rmse": float(np.sqrt(np.mean(norms**2))),
        "mean": float(norms.mean()),
        "median": float(np.median(norms)),
        "std": float(norms.std()),
        "min": float(norms.min()),
        "max": float(norms.max()),
        "num_pairs": int(len(ie)),
    }


def relative_pose_error(
    estimated: Trajectory, ground_truth: Trajectory, delta: int = 1, max_dt: float = 0.02
) -> dict:
    """RPE over a fixed frame-index delta between associated poses,
    translational (m) and rotational (degrees) RMSE (TUM evaluate_rpe
    semantics)."""
    if delta < 1:
        raise ValueError(f"rpe delta must be >= 1, got {delta}")
    ie, ig = associate_timestamps(estimated.timestamps, ground_truth.timestamps, max_dt)
    if len(ie) < delta + 1:
        raise ValueError("not enough associated poses for requested delta")
    trans_err, rot_err = [], []
    for k in range(len(ie) - delta):
        Ee = np.linalg.inv(estimated.pose_matrix(ie[k])) @ estimated.pose_matrix(ie[k + delta])
        Eg = np.linalg.inv(ground_truth.pose_matrix(ig[k])) @ ground_truth.pose_matrix(ig[k + delta])
        E = np.linalg.inv(Eg) @ Ee
        trans_err.append(np.linalg.norm(E[:3, 3]))
        rot_err.append(np.arccos(np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1)))
    trans_err = np.asarray(trans_err)
    rot_err = np.asarray(rot_err)
    return {
        "trans_rmse": float(np.sqrt(np.mean(trans_err**2))),
        "rot_rmse_deg": float(np.degrees(np.sqrt(np.mean(rot_err**2)))),
        "num_pairs": int(len(trans_err)),
    }
