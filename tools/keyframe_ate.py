#!/usr/bin/env python3
"""Keyframe tracking's ATE on chip_smoke.py's out-and-back loop: phovo_tpu
(the JAX reference) beside phovo_tpu_torch, both on the CPU, on the same
frames.

    python3 tools/keyframe_ate.py [--shape 240x320] [--frames 64]

Renders chip_smoke.py's loop (`loop_states`: out along +x to 0.4 m and back
near the start; the synthetic plane; uint8 intensity, uint16 depth counts)
at --shape, with TUM_FR1 scaled to it, and runs KeyframeVisualOdometry over
the analytic and the ceres preset at two settings of the promotion
distance and the loop weight:
  * "6cm/w10": chip_smoke.KF_OPTIONS (6 cm; loop weight 10, the default of
    both packages' KeyframeVisualOdometry);
  * "8cm/w50": tests/test_keyframe.py's fixture (8 cm, weight 50).
Each package runs in a process of its own, so no process imports both, on
the CPU. The analytic preset tracks with run_chunked(chunk=16,
depth_scale) in two modes: level-major against the keyframe (what the port
runs on the card; phovo_tpu's Pallas kernels in interpret mode) and the
serial warm-started scan (levelmajor='off'). The ceres preset tracks
level-major in the port (run_chunked) and through run() in phovo_tpu,
whose ceres run_chunked needs a TPU, on metric depth converted from the
counts as the port converts them. The port runs the kernels' plain
versions. Each package also aligns the frame chain (align_sequence,
align_sequence_autodiff) on the same frames. Each process renders the
frames with its own package and reports their hash; the two must agree.

Prints, per preset, setting and mode, each package's keyframes and loop
closures and the ATE rmse (TUM's, after Horn alignment) after finalize,
before it, and of the frame chain, then one JSON line of the same numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CHUNK = 16
# How each preset's frames are tracked: the analytic preset level-major
# against the keyframe (what run_chunked runs on the card) and as the
# serial warm-started scan; the ceres preset level-major
MODES = {"analytic": ("level-major", "serial"), "ceres": ("level-major",)}


def settings(kf_options: dict) -> dict:
    return {
        "6cm/w10": dict(kf_options),
        "8cm/w50": dict(kf_options, kf_translation=0.08, loop_weight=50.0),
    }


def _render(package, shape, states, depth_scale):
    """(RGBDFrame list with uint16 depth counts, metric-depth twins,
    ground-truth camera-in-world poses, the frames' sha256) rendered with
    `package`'s own camera, synthetic and se3 modules."""
    camera = importlib.import_module(f"{package}.ops.camera")
    synthetic = importlib.import_module(f"{package}.utils.synthetic")
    se3 = importlib.import_module(f"{package}.ops.se3")
    tum = importlib.import_module(f"{package}.datasets.tum")
    level = int(round(np.log2(480 / shape[0])))
    intr = camera.TUM_FR1.at_level(level)
    frames, metric, gts = [], [], []
    h = hashlib.sha256()
    for k, st in enumerate(states):
        T = se3.pose_matrix_np(np.asarray(st))
        I, D = synthetic.render_plane(intr, shape, T)
        I8 = np.round(I * 255.0).astype(np.uint8)
        D16 = np.round(D / depth_scale).astype(np.uint16)
        h.update(I8.tobytes())
        h.update(D16.tobytes())
        fr = tum.RGBDFrame(float(k), float(k), I8, D16)
        frames.append(fr)
        metric.append(dataclasses.replace(fr, depth=D16.astype(np.float32) * np.float32(depth_scale)))
        gts.append(np.linalg.inv(T))
    return intr, frames, metric, gts, h.hexdigest()


def _poses(tracked):
    return [np.asarray(tf.pose, np.float64).tolist() for tf in tracked]


def run_jax(spec: dict) -> dict:
    """phovo_tpu on the CPU: the tracking run and finalize() per preset,
    setting and mode, and the frame chain."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from phovo_tpu.models import analytic, autodiff
    from phovo_tpu.models.keyframe import KeyframeVisualOdometry
    from phovo_tpu.ops import se3
    from phovo_tpu.utils.config import config_from_dict

    intr, frames, metric, _, sha = _render("phovo_tpu", tuple(spec["shape"]), spec["states"], spec["depth_scale"])
    I = np.stack([f.intensity for f in metric])
    D = np.stack([f.depth for f in metric])
    out = {"sha256": sha, "runs": {}, "chain": {}}
    for preset, ceres in (("analytic", False), ("ceres", True)):
        cfg = config_from_dict(spec["presets"][preset])
        for name, opts in spec["settings"].items():
            for mode in MODES[preset]:
                vo = (autodiff.PhotoconsistencyOdometryAutodiff if ceres
                      else analytic.PhotoconsistencyOdometryAnalytic)(cfg)
                vo.set_intrinsic_matrix(np.asarray(intr.matrix()))
                kvo = KeyframeVisualOdometry(vo, **opts)
                if ceres:
                    tracked = kvo.run(metric)
                else:  # the level-major path runs its Pallas kernels in interpret mode
                    tracked = kvo.run_chunked(frames, chunk=CHUNK, depth_scale=spec["depth_scale"],
                                              levelmajor="interpret" if mode == "level-major" else "off")
                before = _poses(list(tracked))
                out["runs"][f"{preset} {name} {mode}"] = dict(
                    keyframes=[k.frame_index for k in kvo.keyframes],
                    closures=[[c.from_kf, c.to_kf] for c in kvo.loop_closures],
                    before=before, after=_poses(kvo.finalize()),
                )
        chain = (autodiff.align_sequence_autodiff if ceres else analytic.align_sequence)(I, D, intr, cfg)
        out["chain"][preset] = np.asarray(se3.integrate_trajectory(chain.state), np.float64).tolist()
    return out


def run_torch(spec: dict) -> dict:
    """phovo_tpu_torch on the CPU: run_chunked(CHUNK) and finalize() per
    preset, setting and mode, and the frame chain."""
    import torch

    from phovo_tpu_torch.models import analytic, autodiff
    from phovo_tpu_torch.models.keyframe import KeyframeVisualOdometry
    from phovo_tpu_torch.ops import se3
    from phovo_tpu_torch.utils.config import config_from_dict

    torch.set_num_threads(4)
    intr, frames, metric, _, sha = _render("phovo_tpu_torch", tuple(spec["shape"]), spec["states"],
                                           spec["depth_scale"])
    I = torch.from_numpy(np.stack([f.intensity for f in metric]))
    D = torch.from_numpy(np.stack([f.depth for f in metric]))
    K = [[intr.fx, 0, intr.cx], [0, intr.fy, intr.cy], [0, 0, 1]]
    out = {"sha256": sha, "runs": {}, "chain": {}}
    for preset, ceres in (("analytic", False), ("ceres", True)):
        cfg = config_from_dict(spec["presets"][preset])
        for name, opts in spec["settings"].items():
            for mode in MODES[preset]:
                cls = autodiff.PhotoconsistencyOdometryAutodiff if ceres else analytic.PhotoconsistencyOdometryAnalytic
                vo = cls(cfg, device="cpu")
                vo.set_intrinsic_matrix(K)
                kvo = KeyframeVisualOdometry(vo, **opts)
                tracked = kvo.run_chunked(frames, chunk=CHUNK, depth_scale=spec["depth_scale"],
                                          levelmajor="off" if mode == "serial" else "auto")
                before = _poses(list(tracked))
                out["runs"][f"{preset} {name} {mode}"] = dict(
                    keyframes=[k.frame_index for k in kvo.keyframes],
                    closures=[[c.from_kf, c.to_kf] for c in kvo.loop_closures],
                    before=before, after=_poses(kvo.finalize()),
                )
        chain = (autodiff.align_sequence_autodiff if ceres else analytic.align_sequence)(I, D, intr, cfg)
        out["chain"][preset] = se3.integrate_trajectory(chain.state).double().numpy().tolist()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="240x320", help="HxW of the rendered frames")
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--child", choices=("phovo_tpu", "phovo_tpu_torch"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    if args.child:
        spec = json.loads(sys.stdin.read())
        print(json.dumps((run_jax if args.child == "phovo_tpu" else run_torch)(spec)))
        return 0

    import chip_smoke
    from phovo_tpu_torch.utils import trajectory as traj

    shape = tuple(int(x) for x in args.shape.split("x"))
    states = chip_smoke.loop_states(args.frames)
    spec = dict(shape=shape, states=[np.asarray(s).tolist() for s in states], depth_scale=chip_smoke.DEPTH_SCALE,
                settings=settings(chip_smoke.KF_OPTIONS),
                presets={"analytic": chip_smoke.ANALYTIC_PRESET, "ceres": chip_smoke.CERES_PRESET})
    results, seconds = {}, {}
    for package in ("phovo_tpu", "phovo_tpu_torch"):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, __file__, "--child", package], input=json.dumps(spec), cwd=ROOT,
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        results[package] = json.loads(proc.stdout.strip().splitlines()[-1])
        seconds[package] = time.perf_counter() - t0
    if results["phovo_tpu"]["sha256"] != results["phovo_tpu_torch"]["sha256"]:
        print("the two packages rendered different frames", file=sys.stderr)
        return 1

    ts = np.arange(args.frames, dtype=np.float64)
    from phovo_tpu_torch.ops import se3

    gts = [np.linalg.inv(se3.pose_matrix_np(np.asarray(s))) for s in states]
    gt = traj.Trajectory.from_poses(ts, np.stack(gts))

    def ate(poses):
        est = traj.Trajectory.from_poses(ts, np.stack([np.eye(4)] + [np.asarray(p) for p in poses]))
        return traj.absolute_trajectory_error(est, gt)["rmse"]

    still = traj.absolute_trajectory_error(traj.Trajectory.from_poses(ts, np.stack([np.eye(4)] * len(ts))), gt)["rmse"]
    print(f"{args.frames} frames {shape[0]}x{shape[1]} (sha256 {results['phovo_tpu']['sha256'][:16]}), standing "
          f"still ATE {still * 1e3:.4f} mm; CPU seconds: {', '.join(f'{k} {v:.1f}' for k, v in seconds.items())}")
    table = {}
    for key in results["phovo_tpu"]["runs"]:
        preset = key.split()[0]
        for package, res in results.items():
            run = res["runs"][key]
            row = dict(keyframes=run["keyframes"], closures=run["closures"],
                       ate_after_mm=ate(run["after"]) * 1e3, ate_before_mm=ate(run["before"]) * 1e3,
                       chain_ate_mm=ate(res["chain"][preset]) * 1e3)
            table[f"{key} {package}"] = row
            print(f"{key:30s} {package:16s} keyframes {row['keyframes']} closures {row['closures']}: ATE after "
                  f"finalize {row['ate_after_mm']:.4f} mm, before {row['ate_before_mm']:.4f} mm, frame chain "
                  f"{row['chain_ate_mm']:.4f} mm")
    print(json.dumps(dict(shape=shape, frames=args.frames, still_mm=still * 1e3, rows=table)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
