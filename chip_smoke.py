#!/usr/bin/env python3
"""Smoke run of phovo_tpu_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):
  1. device: a CUDA card must be present; prints its name and power limit
  2. build: compiles phovo_tpu_torch/csrc/*.cu with nvcc (sm_90a)
  3. kernel vs plain: the level kernel against its plain torch version on
     8 synthetic VGA pairs at every active level, both samplings
  4. main path: 257 synthetic VGA frames (uint8 intensity, uint16 depth
     counts) through align_sequence_chunk in two chunks with early exit,
     once through the kernel and once through the plain version; launch
     counts, per-pair agreement and the ATE against ground truth
  5. timing: the bench.py workload (256 VGA pairs, fixed 75 iterations and
     early exit at ||g|| < 300) and the kernel vs plain time per level
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

SHAPE = (480, 640)
DEPTH_SCALE = 1.0 / 5000.0  # TUM 16-bit depth counts
N_FRAMES = 257  # 256 pairs, as bench.py
CHUNKS = ((1, 129), (129, 257))  # frame ranges of the two chunks
STATE_ATOL = 2e-4  # tests/test_fused_batch.py's level for the batch kernel
# Nearest-sampled Gauss-Newton does not converge on the synthetic plane:
# ||g|| wanders and, after about 5 iterations, a change in the ORDER of
# the float32 pixel sums alone moves the state by more than STATE_ATOL
# (measured on the CPU by summing in float64 instead: 3.6e-5 after 5
# iterations at 60x80, 3.8e-2 after 50 at 30x40). The kernel and the plain
# version sum in different orders, so at fixed iterations they are held
# to each other over 3 nearest iterations (tests/test_fused_batch.py's
# count) and over the whole schedule with bilinear sampling, which
# converges. The main path's early exit stops after 1 iteration a level.
NEAREST_ITERATIONS = 3
REPEATS = 10


def bench_config(min_gradient_norm: float):
    """bench.py's schedule: 5 levels, iterations [0, 0, 5, 20, 50], nearest
    sampling, no robust loss."""
    from phovo_tpu_torch.utils.config import PhovoConfig

    return PhovoConfig(
        num_levels=5, blur_filter_sizes=(0,) * 5, gradient_scales=(0.0625,) * 5,
        max_iterations=(0, 0, 5, 20, 50), lambda_steps=(1.0,) * 5,
        min_gradient_norms=(min_gradient_norm,) * 5, sampling="nearest",
    )


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, repeats: int) -> float:
    """Mean device milliseconds of fn() over `repeats` back-to-back calls,
    by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def pair_packs(prep: dict) -> dict:
    """Per-frame packs -> per-pair packs (source k, target k+1)."""
    return {
        level: (i0[:-1], geom[:-1], t_all[1:])
        for level, (i0, geom, t_all) in prep.items()
    }


def compare_levels(fb, packs, intr, iterations, sampling, card):
    """Kernel vs plain version on the same packs at every active level,
    `iterations[level]` fixed iterations from the zero state; returns the
    largest state difference."""
    from phovo_tpu_torch.ops.pyramid import level_shape

    worst = 0.0
    for level, (i0, geom, t_all) in sorted(packs.items(), reverse=True):
        H, W = level_shape(SHAPE, level)
        args = (
            i0, geom, t_all, intr.at_level(level),
            torch.zeros((i0.shape[0], 6), device=i0.device),
            iterations[level], 0.0, 1.0,
        )
        kw = dict(H=H, W=W, sampling=sampling)
        k = fb.fused_gn_level_batch(*args, **kw)
        p = fb.fused_gn_level_batch_reference(*args, **kw)
        torch.cuda.synchronize()
        err = float((k.state - p.state).abs().max())
        worst = max(worst, err)
        same_its = torch.equal(k.iterations, p.iterations)
        same_nv = torch.equal(k.num_valid, p.num_valid)
        print(
            f"kernel vs plain: level {level} {H}x{W} {sampling} "
            f"{i0.shape[0]} pairs x {iterations[level]} it: "
            f"max|state diff| {err:.3e}, iterations equal {same_its}, "
            f"nvalid equal {same_nv} [{card}]"
        )
        check(err <= STATE_ATOL, f"state diff {err} > {STATE_ATOL}")
        check(same_its and same_nv, "iterations or valid counts differ")
    return worst


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    from phovo_tpu_torch.models import analytic
    from phovo_tpu_torch.models.analytic import align_sequence, align_sequence_chunk, prep_frame_analytic
    from phovo_tpu_torch.ops import _build, se3
    from phovo_tpu_torch.ops import fused_batch as fb
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.utils.synthetic import make_pair, make_sequence
    from phovo_tpu_torch.utils.trajectory import Trajectory, absolute_trajectory_error

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path.name}")

    # 3. kernel vs plain version at the active VGA levels
    cfg_fixed, cfg_ee = bench_config(0.0), bench_config(300.0)
    I, D, _, _ = make_sequence(TUM_FR1, SHAPE, 9)
    prep = prep_frame_analytic(
        torch.from_numpy(np.stack(I)).to(dev), torch.from_numpy(np.stack(D)).to(dev),
        TUM_FR1, cfg_fixed,
    )
    max_err = 0.0
    for sampling in ("nearest", "bilinear"):
        iterations = {
            level: n if sampling == "bilinear" else min(n, NEAREST_ITERATIONS)
            for level, n in enumerate(cfg_fixed.max_iterations)
        }
        max_err = max(max_err, compare_levels(fb, pair_packs(prep), TUM_FR1, iterations, sampling, card))

    # 4. the main path: 257 frames through align_sequence_chunk, two chunks
    t0 = time.perf_counter()
    I, D, gts, ts = make_sequence(TUM_FR1, SHAPE, N_FRAMES)
    I8 = np.round(np.stack(I) * 255.0).astype(np.uint8)
    D16 = np.round(np.stack(D) / DEPTH_SCALE).astype(np.uint16)
    print(f"main path: rendered {N_FRAMES} frames in {time.perf_counter() - t0:.1f} s")

    def run_chain():
        carry_i = torch.from_numpy(I8[0]).to(dev)
        carry_d = torch.from_numpy(D16[0]).to(dev).to(torch.float32) * float(np.float32(DEPTH_SCALE))
        parts = []
        for lo, hi in CHUNKS:
            res, carry_i, carry_d = align_sequence_chunk(
                carry_i, carry_d, torch.from_numpy(I8[lo:hi]).to(dev),
                torch.from_numpy(D16[lo:hi]).to(dev), TUM_FR1, cfg_ee,
                depth_scale=DEPTH_SCALE,
            )
            parts.append(res)
        torch.cuda.synchronize()
        return type(parts[0])(*(torch.cat(x) for x in zip(*parts)))

    fb.LAUNCHES = 0
    kern = run_chain()
    launches = fb.LAUNCHES
    active = sum(1 for n in cfg_ee.max_iterations if n > 0)
    print(f"main path: kernel launches {launches} (expected {active} levels x {len(CHUNKS)} chunks)")
    check(launches == active * len(CHUNKS), "the main path did not launch the kernel at every level of every chunk")

    fb.LAUNCHES = 0
    with mock.patch.object(analytic, "fused_gn_level_batch", fb.fused_gn_level_batch_reference):
        plain = run_chain()
    check(fb.LAUNCHES == 0, "the plain run launched the kernel")

    chain_err = float((kern.state - plain.state).abs().max())
    max_err = max(max_err, chain_err)
    its_k, its_p = kern.iterations.cpu().numpy(), plain.iterations.cpu().numpy()
    print(f"main path: {kern.state.shape[0]} pairs, max|state diff| kernel vs plain {chain_err:.3e}, "
          f"iterations per level (mean) {its_k.mean(axis=0).round(3).tolist()}")
    check(chain_err <= STATE_ATOL, f"main-path state diff {chain_err}")
    check(np.array_equal(its_k, its_p), "main-path iterations differ")
    check(torch.equal(kern.num_valid, plain.num_valid), "main-path valid counts differ")
    check(bool(torch.isfinite(kern.state).all()), "non-finite states")
    check(tuple(kern.state.shape) == (N_FRAMES - 1, 6), f"state shape {tuple(kern.state.shape)}")

    poses = np.concatenate([np.eye(4)[None], se3.integrate_trajectory(kern.state).cpu().double().numpy()])
    gt = Trajectory.from_poses(ts, np.stack(gts))
    ate = absolute_trajectory_error(Trajectory.from_poses(ts, poses), gt)["rmse"]
    ate_still = absolute_trajectory_error(Trajectory.from_poses(ts, np.tile(np.eye(4), (N_FRAMES, 1, 1))), gt)["rmse"]
    print(f"main path: ATE rmse {ate:.6f} m (identity trajectory {ate_still:.6f} m)")
    check(np.isfinite(ate) and ate < ate_still, "ATE not finite or not below standing still")

    # 5. timing: the bench.py workload, device-resident frames
    I0, D0, I1, D1, _ = make_pair(TUM_FR1, SHAPE)
    Is = torch.from_numpy(np.stack([I0, I1] * ((N_FRAMES + 1) // 2))[:N_FRAMES]).to(dev)
    Ds = torch.from_numpy(np.stack([D0, D1] * ((N_FRAMES + 1) // 2))[:N_FRAMES]).to(dev)
    n_pairs = N_FRAMES - 1
    ms_fixed = cuda_ms(lambda: align_sequence(Is, Ds, TUM_FR1, cfg_fixed), REPEATS)
    ms_ee = cuda_ms(lambda: align_sequence(Is, Ds, TUM_FR1, cfg_ee), REPEATS)
    print(f"bench workload fixed-75: {1e3 * n_pairs / ms_fixed:.1f} frames/s ({ms_fixed:.3f} ms / {n_pairs} pairs) [{card}]")
    print(f"bench workload early exit: {1e3 * n_pairs / ms_ee:.1f} pairs/s ({ms_ee:.3f} ms / {n_pairs} pairs) [{card}]")

    ms_prep = cuda_ms(lambda: prep_frame_analytic(Is, Ds, TUM_FR1, cfg_fixed), REPEATS)
    print(f"layer prep (pyramids, Scharr, packs of {N_FRAMES} frames): {ms_prep:.3f} ms [{card}]")
    packs = pair_packs(prep_frame_analytic(Is, Ds, TUM_FR1, cfg_fixed))
    from phovo_tpu_torch.ops.pyramid import level_shape

    kernel_ms = plain_ms = 0.0
    for level, (i0, geom, t_all) in sorted(packs.items(), reverse=True):
        H, W = level_shape(SHAPE, level)
        args = (i0, geom, t_all, TUM_FR1.at_level(level), torch.zeros((n_pairs, 6), device=dev),
                cfg_fixed.max_iterations[level], 0.0, 1.0)
        kw = dict(H=H, W=W, sampling="nearest")
        # plain, kernel, kernel, plain: both see the same card state
        p1 = cuda_ms(lambda: fb.fused_gn_level_batch_reference(*args, **kw), 2)
        k1 = cuda_ms(lambda: fb.fused_gn_level_batch(*args, **kw), REPEATS)
        k2 = cuda_ms(lambda: fb.fused_gn_level_batch(*args, **kw), REPEATS)
        p2 = cuda_ms(lambda: fb.fused_gn_level_batch_reference(*args, **kw), 2)
        k, p = (k1 + k2) / 2, (p1 + p2) / 2
        kernel_ms += k
        plain_ms += p
        print(f"layer level kernel: level {level} {H}x{W}, {n_pairs} pairs x {cfg_fixed.max_iterations[level]} it: "
              f"kernel {k:.3f} ms ({k1:.3f}, {k2:.3f}), plain {p:.3f} ms ({p1:.3f}, {p2:.3f}) [{card}]")
    states = torch.zeros((n_pairs, 6), device=dev)
    ms_integrate = cuda_ms(lambda: se3.integrate_trajectory(states), REPEATS)
    print(f"layer integrate ({n_pairs} poses): {ms_integrate:.3f} ms [{card}]")

    record = {"kernels": [{
        "name": "fused_gn_level_batch",
        "route": "cuda",
        "source": "phovo_tpu_torch/csrc/fused_gn_batch.cu",
        "replaces": "phovo_tpu/ops/fused_batch.py:607",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
