"""CLI: evaluate an estimated trajectory against ground truth (ATE / RPE);
torch port of phovo_tpu/apps/phovo_eval.py, the same flags and output.

    python -m phovo_tpu_torch.apps.phovo_eval <groundtruth.txt> <estimated.txt> \
        [--mode ate|rpe|both] [--max-dt 0.02] [--rpe-delta 1] [--json]

Both files are TUM format, `timestamp tx ty tz qx qy qz qw`, '#' comments
skipped. ATE associates timestamps (nearest within --max-dt), aligns the
trajectories (Horn) and reports the translational RMSE; RPE compares
relative motions over a fixed frame delta (utils/trajectory.py, the TUM
tools' semantics). The arithmetic is float64 numpy on the host, which
needs no card, so it takes no --device.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="phovo-eval", description="ATE/RPE evaluation of TUM-format trajectories")
    p.add_argument("groundtruth", help="ground-truth trajectory (TUM format)")
    p.add_argument("estimated", help="estimated trajectory (TUM format)")
    p.add_argument("--mode", default="both", choices=["ate", "rpe", "both"])
    p.add_argument("--max-dt", type=float, default=0.02, help="timestamp association tolerance in seconds")
    p.add_argument("--rpe-delta", type=int, default=1, help="frame-index delta for relative pose error")
    p.add_argument("--json", action="store_true", help="print one machine-readable JSON object")
    return p


def main(argv=None) -> int:
    try:
        return _main(argv)
    except (FileNotFoundError, ValueError, IOError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from phovo_tpu_torch.utils.trajectory import absolute_trajectory_error, read_trajectory, relative_pose_error

    gt = read_trajectory(args.groundtruth)
    est = read_trajectory(args.estimated)
    out: dict = {}
    if args.mode in ("ate", "both"):
        out["ate"] = absolute_trajectory_error(est, gt, max_dt=args.max_dt)
    if args.mode in ("rpe", "both"):
        out["rpe"] = relative_pose_error(est, gt, delta=args.rpe_delta, max_dt=args.max_dt)

    if args.json:
        print(json.dumps(out))
        return 0
    if "ate" in out:
        a = out["ate"]
        print(f"ATE over {a['num_pairs']} associated poses:")
        for key in ("rmse", "mean", "median", "std", "min", "max"):
            print(f"  {key:<6} {a[key]:.6f} m")
    if "rpe" in out:
        r = out["rpe"]
        print(f"RPE over {r['num_pairs']} pairs (delta={args.rpe_delta}):")
        print(f"  trans rmse {r['trans_rmse']:.6f} m")
        print(f"  rot rmse   {r['rot_rmse_deg']:.6f} deg")
    return 0


if __name__ == "__main__":
    sys.exit(main())
