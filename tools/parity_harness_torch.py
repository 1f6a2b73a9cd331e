"""Per-preset trajectory parity of the PyTorch port: phovo_tpu_torch
against the reference-exact oracle (tools/reference_oracle.py).

The port's counterpart of tools/parity_harness.py (which runs phovo_tpu):
the same synthetic RGB-D sequence goes through (a) the float64 oracle,
a bug-for-bug emulation of the reference backends, and (b) the port's
backend of the same name (BACKENDS), for every shipped preset, with the
reference VO app's loop (zero init per pair, pose <- pose @ Rt^-1). It
reports the ATE between the two trajectories and each one's ATE against
the exact ground truth, in tools/parity_harness.py's markdown and JSON
formats.

    python -m tools.parity_harness_torch --scene cluttered --frames 10 \
        --shape 240 320 --out-md parity.md --out-json parity.json [--device cuda]

--scene plane|cluttered|rotation (utils/synthetic.py: the textured
plane; occluding boxes with depth noise, holes and exposure drift; a
rotation-dominant path), --presets name1,name2 to subset. The port runs
on --device, the CUDA card unless the caller names another. The oracle
builds its pyramids with OpenCV; where cv2 is not installed (the card's
machine) it gets NumpyCV2, a numpy stand-in for the three OpenCV
functions it calls, equal to OpenCV's float64 results to ~1e-15.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

ALL_PRESETS = [
    "config_4_level_optimization_analytic",
    "config_5_level_optimization_analytic",
    "config_6_level_optimization_analytic",
    "config_only_level_0_analytic",
    "config_3_level_optimization_ceres",
    "config_4_level_optimization_ceres",
    "config_5_level_optimization_ceres",
    "config_only_level_0_ceres",
    "config_only_level_1_ceres",
    "config_only_level_2_ceres",
    "config_only_level_3_ceres",
    "config_only_level_4_ceres",
]


class NumpyCV2:
    """cv2.resize (INTER_LINEAR, whose exact 2x downscale OpenCV runs as
    the 2x2 area mean), cv2.GaussianBlur and cv2.Scharr on float64 images
    with BORDER_REFLECT_101, in numpy: what the oracle calls, for a machine
    without OpenCV."""

    CV_64F = 6

    @staticmethod
    def _pad(img, axis, before, after):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (before, after)
        return np.pad(img, pad, mode="reflect")

    @staticmethod
    def resize(img, dsize, fx=0.0, fy=0.0):
        img = np.asarray(img, np.float64)
        H, W = img.shape
        Ho, Wo = int(np.rint(H * fy)), int(np.rint(W * fx))
        if (H, W) == (2 * Ho, 2 * Wo):
            return (((img[0::2, 0::2] + img[0::2, 1::2]) + img[1::2, 0::2]) + img[1::2, 1::2]) * 0.25

        def taps(n_in, n_out, scale):
            # OpenCV maps with the given factor, not the size ratio
            f = np.float32((np.arange(n_out) + 0.5) * (1.0 / scale) - 0.5)
            i0 = np.floor(f).astype(np.int64)
            a = (f - i0).astype(np.float32)
            a[i0 < 0], i0[i0 < 0] = 0, 0
            edge = i0 >= n_in - 1
            a[edge], i0[edge] = 0, n_in - 1
            return i0, np.minimum(i0 + 1, n_in - 1), (np.float32(1) - a).astype(np.float64), a.astype(np.float64)

        c0, c1, ca, cb = taps(W, Wo, fx)
        r0, r1, ra, rb = taps(H, Ho, fy)
        h = img[:, c0] * ca + img[:, c1] * cb
        return h[r0] * ra[:, None] + h[r1] * rb[:, None]

    @staticmethod
    def _sep_filter(img, kx, ky):
        """Rows with kx, then columns with ky (OpenCV's separable order);
        a symmetric or antisymmetric column kernel pairs its taps."""
        img = np.asarray(img, np.float64)
        H, W = img.shape
        n, c = len(kx), len(ky) // 2
        p = NumpyCV2._pad(img, 1, n // 2, n - 1 - n // 2)
        rows = kx[0] * p[:, :W]
        for k in range(1, n):
            rows = rows + kx[k] * p[:, k:k + W]
        p = NumpyCV2._pad(rows, 0, c, c)

        def at(k):
            return p[c + k:c + k + H]

        if np.array_equal(ky, ky[::-1]):
            out = ky[c] * at(0)
            for k in range(1, c + 1):
                out = out + ky[c + k] * (at(k) + at(-k))
            return out
        out = np.zeros_like(rows)
        for k in range(1, c + 1):
            out = out + ky[c + k] * (at(k) - at(-k))
        return out

    @staticmethod
    def GaussianBlur(img, ksize, sigma):
        x = np.arange(ksize[0]) - (ksize[0] - 1) * 0.5
        g = np.exp(-0.5 / (sigma * sigma) * x * x)
        g = g * (1.0 / g.sum())
        return NumpyCV2._sep_filter(img, g, g)

    @staticmethod
    def Scharr(img, ddepth, dx, dy, scale=1.0, delta=0.0):
        deriv, smooth = np.array([-1.0, 0.0, 1.0]), np.array([3.0, 10.0, 3.0])
        kx, ky = (deriv, smooth * scale) if dx else (smooth * scale, deriv)
        return NumpyCV2._sep_filter(img, kx, ky) + delta


def oracle_module():
    """tools/reference_oracle, with NumpyCV2 in place of OpenCV where cv2
    is not installed."""
    from tools import reference_oracle

    if reference_oracle.cv2 is None:
        reference_oracle.cv2 = NumpyCV2
    return reference_oracle


def preset_plan(preset_names):
    """(preset, backend) pairs: the analytic presets run the analytic
    backend and, but for the one-level preset, the bi-objective one (it
    shares the analytic Gauss-Newton schema); the ceres presets run the
    trust-region backend ('autodiff')."""
    plan = []
    for name in preset_names:
        if "analytic" in name:
            plan.append((name, "analytic"))
            if "only_level" not in name:
                plan.append((name, "biobjective"))
        else:
            plan.append((name, "autodiff"))
    return plan


def run_vo(model, intensities, depths, K, pose_matrix_fn):
    """The reference VO loop: each consecutive pair optimized from zero,
    pose <- pose @ Rt^-1. Returns ((N, 4, 4) world_from_cam poses, (N-1,
    6) float64 states)."""
    model.set_intrinsic_matrix(K)
    poses, states = [np.eye(4)], []
    for k in range(len(intensities) - 1):
        model.set_source_frame(intensities[k], depths[k])
        model.set_target_frame(intensities[k + 1], depths[k + 1])
        model.set_initial_state_vector(np.zeros(6))
        out = model.optimize()
        state = getattr(out, "state", out)  # an AlignmentResult, or the oracle's state
        state = np.asarray(state.cpu() if hasattr(state, "cpu") else state, np.float64)
        states.append(state)
        poses.append(poses[-1] @ np.linalg.inv(np.asarray(pose_matrix_fn(state), np.float64)))
    return np.stack(poses), np.stack(states)


def ate_rmse(poses_a: np.ndarray, poses_b: np.ndarray) -> float:
    """ATE RMSE between two pose arrays (Horn alignment, TUM semantics)."""
    from phovo_tpu_torch.utils.trajectory import horn_align

    P, Q = poses_a[:, :3, 3], poses_b[:, :3, 3]
    R, t = horn_align(P, Q)
    err = (P @ R.T + t) - Q
    return float(np.sqrt(np.mean(np.sum(err**2, axis=1))))


def scene_frames(scene: str, shape, frames: int, motion_scale: float = 1.0, seed: int = 0):
    """(intensities, depths, ground-truth world_from_cam poses, K) of a
    synthetic sequence at tools/parity_harness.py's camera (fx = 525 W /
    640, the principal point at the centre)."""
    from phovo_tpu_torch.ops.camera import Intrinsics
    from phovo_tpu_torch.utils import synthetic

    H, W = shape
    fx = 525.0 * W / 640.0
    K = np.array([[fx, 0, (W - 1) / 2], [0, fx, (H - 1) / 2], [0, 0, 1.0]])
    intr = Intrinsics(*(float(np.float32(v)) for v in (fx, fx, (W - 1) / 2, (H - 1) / 2)))
    if scene == "plane":
        I, D, gts, _ = synthetic.make_sequence(intr, (H, W), frames, motion_scale, seed)
    elif scene == "rotation":
        I, D, gts, _ = synthetic.make_sequence(intr, (H, W), frames, motion_scale, seed, trajectory="rotation")
    else:
        I, D, gts, _ = synthetic.make_cluttered_sequence(intr, (H, W), frames, motion_scale, seed)
    return I, D, np.stack(gts), K


def run_harness(I, D, gt_poses, K, presets, device, out=print):
    """One row a (preset, backend) of preset_plan: the oracle's and the
    port's trajectories over the frames (uint8 intensity to both; float64
    depth to the oracle, float32 metres to the port), their ATE against
    each other and against ground truth, the largest per-pair state
    difference and each side's seconds."""
    from phovo_tpu_torch.models import BACKENDS
    from phovo_tpu_torch.ops import se3
    from phovo_tpu_torch.utils.config import load_builtin

    ro = oracle_module()
    I_u8 = [(img * 255).astype(np.uint8) for img in I]
    D64 = [d.astype(np.float64) for d in D]
    rows = []
    for preset, backend in preset_plan(presets):
        cfg = load_builtin(preset)
        t0 = time.time()
        o_poses, o_states = run_vo(ro.oracle_for_backend(backend, cfg), I_u8, D64, K, ro.pose_matrix)
        t_oracle = time.time() - t0
        t0 = time.time()
        f_poses, f_states = run_vo(BACKENDS[backend](cfg, device=device), I_u8, D, K, se3.pose_matrix_np)
        t_fw = time.time() - t0
        row = {
            "preset": preset,
            "backend": backend,
            "ate_fw_vs_oracle": ate_rmse(f_poses, o_poses),
            "ate_oracle_vs_gt": ate_rmse(o_poses, gt_poses),
            "ate_fw_vs_gt": ate_rmse(f_poses, gt_poses),
            "max_state_delta": float(np.max(np.linalg.norm(f_states - o_states, axis=1))),
            "oracle_seconds": round(t_oracle, 2),
            "framework_seconds": round(t_fw, 2),
        }
        rows.append(row)
        out(f"{preset:40s} {backend:12s} fw-vs-oracle ATE {row['ate_fw_vs_oracle']:.5f} (oracle-vs-gt "
            f"{row['ate_oracle_vs_gt']:.5f}, fw-vs-gt {row['ate_fw_vs_gt']:.5f})")
    return rows


def write_tables(rows, meta: dict, out_md=None, out_json=None) -> None:
    """tools/parity_harness.py's JSON (meta and rows) and markdown table."""
    if out_json:
        with open(out_json, "w") as f:
            json.dump({**meta, "rows": rows}, f, indent=1)
    if out_md:
        lines = ["| preset | backend | ATE fw vs oracle (m) | ATE oracle vs GT | ATE fw vs GT | max state delta |",
                 "|---|---|---|---|---|---|"]
        lines += [f"| {r['preset']} | {r['backend']} | {r['ate_fw_vs_oracle']:.5f} | {r['ate_oracle_vs_gt']:.5f} "
                  f"| {r['ate_fw_vs_gt']:.5f} | {r['max_state_delta']:.5f} |" for r in rows]
        with open(out_md, "w") as f:
            f.write("\n".join(lines) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--shape", type=int, nargs=2, default=(480, 640))
    ap.add_argument("--motion-scale", type=float, default=1.0)
    ap.add_argument("--scene", default="plane", choices=("plane", "cluttered", "rotation"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--presets", default="all")
    ap.add_argument("--device", default="cuda", help="torch device of the port (default: the CUDA card)")
    ap.add_argument("--out-md", default=None)
    ap.add_argument("--out-json", default=None)
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: torch finds no CUDA card; pass --device cpu")
    I, D, gt_poses, K = scene_frames(args.scene, tuple(args.shape), args.frames, args.motion_scale, args.seed)
    names = ALL_PRESETS if args.presets == "all" else args.presets.split(",")
    rows = run_harness(I, D, gt_poses, K, names, device, out=lambda s: print(s, flush=True))
    meta = {"frames": args.frames, "shape": list(args.shape), "scene": args.scene, "motion_scale": args.motion_scale,
            "device": str(device)}
    write_tables(rows, meta, args.out_md, args.out_json)
    return rows


if __name__ == "__main__":
    main()
