#!/usr/bin/env python3
"""The keyframe pose graph solved with and without `bucket` padding, on one
NVIDIA GPU.

    python3 tools/pose_graph_ab.py

Builds chip_smoke.py's keyframe loop (64 VGA frames out and back), runs
KeyframeVisualOdometry.run_chunked over it with the analytic and the ceres
preset, and solves each run's pose graph (built after the run's
finalize(), the same poses and edges) as finalize() does (10 Gauss-Newton
steps, the tracker's solver) with bucket=False (the graph's
own pose and edge counts) and bucket=True (padded to powers of two, floor
32 poses and 64 edges), in turns (off, on, on, off), each the mean host
wall time of REPEATS synchronized solves after a warm-up. Prints the times,
the graph's sizes and the largest state difference between the two, with
the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPEATS = 5


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from phovo_tpu_torch.ops import _build, se3
    from phovo_tpu_torch.parallel.pose_graph import optimize_pose_graph
    from phovo_tpu_torch.utils.config import config_from_dict

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    _build.library()
    dev = torch.device("cuda", 0)
    frames, _ = chip_smoke.keyframe_frames(se3)
    for name, preset, ceres in (("analytic", chip_smoke.ANALYTIC_PRESET, False),
                                ("ceres", chip_smoke.CERES_PRESET, True)):
        kvo = chip_smoke.keyframe_run(frames, config_from_dict(preset), ceres)[0]
        graph = kvo.build_pose_graph()

        def solve(bucket):
            states, _ = optimize_pose_graph(graph, iterations=10, solver=kvo.pg_solver, bucket=bucket, device=dev)
            torch.cuda.synchronize()
            return states

        def wall_ms(bucket):
            solve(bucket)
            t0 = time.perf_counter()
            for _ in range(REPEATS):
                solve(bucket)
            return (time.perf_counter() - t0) * 1e3 / REPEATS

        times = {False: [], True: []}
        for bucket in (False, True, True, False):
            times[bucket].append(wall_ms(bucket))
        diff = float((solve(False) - solve(True)).abs().max())
        M, K = len(kvo.keyframes), len(graph.weights)
        print(f"pose graph {name}: {M} poses, {K} edges, solver {kvo.pg_solver}; 10 Gauss-Newton steps: "
              f"bucket=False {times[False][0]:.2f}, {times[False][1]:.2f} ms; bucket=True {times[True][0]:.2f}, "
              f"{times[True][1]:.2f} ms; max|state diff| {diff:.3e} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
