#!/usr/bin/env python3
"""Smoke run of phovo_tpu_torch's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):
  1. device: a CUDA card must be present; prints its name and power limit
  2. build: compiles phovo_tpu_torch/csrc/*.cu with nvcc (sm_90a)
  3. kernels vs plain: the GN level kernel against its plain torch version
     on 8 synthetic VGA pairs at every active level of the bench schedule,
     both samplings; the trust-region kernel against its plain version on
     8 VGA pairs at every level of config_5_level_optimization_ceres, with
     its budgets, its tolerances, and each stopping test set to stop pairs
     early
  4. analytic main path: 257 synthetic VGA frames (uint8 intensity, uint16
     depth counts) through align_sequence_chunk in two chunks with early
     exit, once through the kernel and once through the plain version;
     launch counts, per-pair agreement and the ATE against ground truth
  5. ceres main path: the same frames through align_sequence_chunk_autodiff
     with the shipped ceres preset, the same checks
  6. per-pair object API: 4 pairs through
     PhotoconsistencyOdometryAutodiff.optimize() and a warm-started chain,
     one trust-region launch per pair per level; the warm chain once more
     through the plain version
  7. timing: the bench.py workload (256 VGA pairs, fixed 75 iterations and
     early exit at ||g|| < 300), 256 VGA pairs of the ceres preset through
     align_sequence_autodiff, each kernel vs its plain version per level,
     and one pair through the per-pair route
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
# Costs are float32 sums of r^2 >= 0. The kernel sums 1,200 pixels a thread
# at 480x640 before its shuffle and warp passes, so the standard bound on
# such a sum (Higham's gamma_n, n = 1,211 additions) is 7.2e-5 of the cost
# on its side alone; torch's tree reduction adds its own. The reading there
# is 9.675e-5 on every run (both sums are deterministic); 1e-4 is kept as
# the bound tests/test_fused_batch.py pins for the TPU kernels.
COST_RTOL = 1e-4
# max|J^T r| (tests/test_torch_trust_region.py's level), compared on the
# pairs an early-exit case stopped before its budget: those cases start
# from the zero state, far from convergence. Near a converged state it is
# float32 noise (3.6e-3 apart between kernel and plain on the ceres preset
# at 60x80, 5.6e-4 two iterations after the 30x40 level's states; H100).
GNORM_RTOL = 1e-3
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
# The shipped preset phovo_tpu/configs/config_5_level_optimization_ceres.yml
# as its YAML mapping (this machine need not have pyyaml);
# tests/test_torch_trust_region.py holds it to the file.
CERES_PRESET = {
    "num_levels": 5,
    "blur_filter_sizes": [0, 0, 0, 0, 0],
    "gradient_scales": [0.0625] * 5,
    "max_iterations": [2, 2, 5, 10, 50],
    "function_tolerances": ["1e-4"] * 5,
    "gradient_tolerances": ["1e-3"] * 5,
    "parameter_tolerances": ["1e-4", "1e-4", "1e-6", "1e-6", "1e-6"],
    "initial_trust_region_radii": ["1e8", "1e4", "1e4", "1e4", "1e4"],
    "max_trust_region_radii": ["1e8"] * 5,
    "min_trust_region_radii": ["1e-32"] * 5,
    "min_relative_decreases": ["1e-3"] * 5,
    "num_threads": 2,
    "num_linear_solver_threads": 2,
    "progress_to_stdout": True,
    "visualize_iterations": False,
    "sampling": "bilinear",
}
N_API_PAIRS = 4
# The trust region's stopping tests switched off: no float32 cost change,
# step or gradient reaches these.
TR_TESTS_OFF = dict(function_tolerance=1e-9, gradient_tolerance=1e-12, parameter_tolerance=1e-10)
EARLY_EXIT_ITERATIONS = 4
# an early-exit tolerance lies at least this factor from every value its
# test compares with it, so another summation order cannot flip a stop
EARLY_EXIT_MARGIN = 1.07


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


def reset_counts(fb) -> None:
    fb.LAUNCHES = 0
    fb.TR_LAUNCHES = 0


def compare_levels(fb, packs, intr, iterations, sampling, card):
    """GN kernel vs plain version on the same packs at every active level,
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


def stop_values(fb, args, opts, H, W, sampling="bilinear"):
    """What each trust-region stopping test compares with its tolerance,
    per pair, after 0..opts.max_iterations iterations of the plain version
    with every test off: {option name: (iterations + 1, B) float64}. The
    gradient test reads max|J^T r| at the state; the function test
    |dcost| / cost of the step; the parameter test ||step|| against
    ptol (||x|| + ptol), given here as the ptol that just stops it. The
    step tests read accepted steps only: NaN elsewhere and at iteration 0."""
    off = opts._replace(**TR_TESTS_OFF)
    runs = [
        fb.fused_tr_level_batch_reference(*args, off._replace(max_iterations=n), H=H, W=W, sampling=sampling)
        for n in range(opts.max_iterations + 1)
    ]
    state = torch.stack([r.state for r in runs]).double().cpu()
    cost = torch.stack([r.cost for r in runs]).double().cpu()
    gnorm = torch.stack([r.gradient_norm for r in runs]).double().cpu()
    step = state[1:] - state[:-1]
    accepted = (step != 0).any(dim=2)
    nan = torch.full_like(cost[:1], float("nan"))
    f = torch.where(accepted, (cost[:-1] - cost[1:]).abs() / cost[:-1], float("nan"))
    s, x = step.norm(dim=2), state[:-1].norm(dim=2)
    p = torch.where(accepted, 2 * s / (x + torch.sqrt(x * x + 4 * s)), float("nan"))
    return {
        "gradient_tolerance": gnorm,
        "function_tolerance": torch.cat([nan, f]),
        "parameter_tolerance": torch.cat([nan, p]),
    }


def predicted_stops(values, tol):
    """Per pair, the iteration count at which a stopping test with
    tolerance tol stops the level (the budget if it never does)."""
    hit = values <= tol  # NaN never stops
    return torch.where(hit.any(dim=0), hit.to(torch.int8).argmax(dim=0), values.shape[0] - 1)


def early_exit_tolerance(values):
    """(tolerance, iterations (B,) it predicts) for one stopping test from
    its stop_values. Every value the test reads up to the iteration where
    it stops a pair lies at least EARLY_EXIT_MARGIN from the tolerance;
    every pair iterates, one at least stops before the budget, and among
    such tolerances the pairs stop after as many different counts as
    possible, then as many before the budget, then as late."""
    n = values.shape[0] - 1
    read = torch.arange(n + 1)[:, None]
    v = values[torch.isfinite(values) & (values > 0)].unique().tolist()
    best = None
    # candidates just outside the margin of each value, above and below
    for tol in [x * EARLY_EXIT_MARGIN * 1.001 for x in v] + [x / EARLY_EXIT_MARGIN / 1.001 for x in v]:
        stops = predicted_stops(values, tol)
        ratio = (values / tol)[read <= stops]
        ratio = ratio[torch.isfinite(ratio)]
        if not bool(((ratio >= EARLY_EXIT_MARGIN) | (ratio <= 1 / EARLY_EXIT_MARGIN)).all()):
            continue
        score = (len(stops.unique()), int((stops < n).sum()), -tol)
        if score[1] and bool((stops > 0).all()) and (best is None or score > best[0]):
            best = (score, tol, stops)
    check(best is not None, "no early-exit tolerance off its test's boundaries")
    return best[1], best[2]


def compare_tr_results(k, p, what, strict, settled=None):
    """Trust-region kernel vs plain results of B pairs. Always: states
    within STATE_ATOL, and costs within COST_RTOL on the pairs whose
    iteration counts agree. settled, a (B,) mask of the pairs short of
    convergence: max|J^T r| within GNORM_RTOL there. strict: iteration and
    valid counts equal too. Otherwise (the shipped tolerances, where
    |dcost| <= ftol cost on float32 sums taken in different orders can flip
    by one iteration) the differing pairs are counted and printed. Returns
    (max state diff, pairs whose iterations differ)."""
    B = k.state.shape[0]
    err = float((k.state - p.state).abs().max())
    same_its = k.iterations == p.iterations
    n_its = int((~same_its).reshape(B, -1).any(dim=1).sum())
    n_nv = int((k.num_valid != p.num_valid).reshape(B, -1).any(dim=1).sum())

    def max_rel(a, b, where):
        rel = ((a - b).abs() / b.abs().clamp_min(1e-30))[where]
        return float(rel.max()) if rel.numel() else 0.0

    cost_rel = max_rel(k.cost, p.cost, same_its)
    settled = torch.zeros_like(same_its) if settled is None else same_its & settled.to(same_its.device)
    gnorm_rel = max_rel(k.gradient_norm, p.gradient_norm, settled)
    print(
        f"{what}: max|state diff| {err:.3e}, pairs with other iterations "
        f"{n_its} of {B}, other valid counts {n_nv}, max cost rel diff "
        f"{cost_rel:.3e}"
        + (f", max|J^T r| rel diff {gnorm_rel:.3e} on {int(settled.sum())} pairs" if bool(settled.any()) else "")
    )
    check(err <= STATE_ATOL, f"{what}: state diff {err} > {STATE_ATOL}")
    check(cost_rel <= COST_RTOL, f"{what}: cost rel diff {cost_rel} > {COST_RTOL}")
    check(gnorm_rel <= GNORM_RTOL, f"{what}: max|J^T r| rel diff {gnorm_rel} > {GNORM_RTOL}")
    if strict:
        check(n_its == 0 and n_nv == 0, f"{what}: iterations or valid counts differ")
    return err, n_its


def compare_tr_levels(fb, packs, intr, cfg, card):
    """Trust-region kernel vs plain version at every level of cfg, chained
    coarse to fine from the zero state: every case of a level starts at the
    kernel's states of the level before under cfg's own tolerances. The
    cases of a level:
      budget: cfg's iterations and radii with the stopping tests off, so
        every pair runs its whole budget;
      preset: cfg's own tolerances (compare_tr_results counts the pairs
        whose iterations differ);
      one early-exit case per stopping test, from the zero state:
        EARLY_EXIT_ITERATIONS with that test's tolerance set between the
        values it reads (early_exit_tolerance); both versions must stop
        where the plain version's values predict, and max|J^T r| is
        compared on the pairs stopped before the budget.
    Returns the largest state difference."""
    from phovo_tpu_torch.ops.pyramid import level_shape

    worst = 0.0
    init = None
    for level, (i0, geom, t_all) in sorted(packs.items(), reverse=True):
        H, W = level_shape(SHAPE, level)
        if init is None:
            init = torch.zeros((i0.shape[0], 6), device=i0.device)
        args = (i0, geom, t_all, intr.at_level(level), init)
        opts = cfg.trust_region_options(level)
        B = i0.shape[0]
        cases = [("budget", args, opts._replace(**TR_TESTS_OFF), None), ("preset", args, opts, None)]
        early = opts._replace(max_iterations=EARLY_EXIT_ITERATIONS, **TR_TESTS_OFF)
        zero = args[:-1] + (torch.zeros_like(init),)
        for name, values in stop_values(fb, zero, early, H, W).items():
            tol, stops = early_exit_tolerance(values)
            cases.append((f"{name} {tol:.6g} from zero", zero, early._replace(**{name: tol}), stops))
        for name, case_args, case_opts, stops in cases:
            k = fb.fused_tr_level_batch(*case_args, case_opts, H=H, W=W)
            p = fb.fused_tr_level_batch_reference(*case_args, case_opts, H=H, W=W)
            torch.cuda.synchronize()
            what = (
                f"trust-region kernel vs plain: level {level} {H}x{W} {B} pairs, "
                f"{name}, iterations {k.iterations.tolist()} [{card}]"
            )
            settled = None if stops is None else stops < EARLY_EXIT_ITERATIONS
            err, _ = compare_tr_results(k, p, what, strict=name != "preset", settled=settled)
            worst = max(worst, err)
            if stops is not None:
                check(p.iterations.cpu().tolist() == stops.tolist(),
                      f"{what}: the plain version did not stop after {stops.tolist()}")
            if name == "preset":
                init_next = k.state
        init = init_next
    return worst


def trajectory_ate(se3, traj, states, gts, ts):
    """(ATE rmse of the integrated states, ATE of standing still), metres."""
    poses = np.concatenate([np.eye(4)[None], se3.integrate_trajectory(states).cpu().double().numpy()])
    gt = traj.Trajectory.from_poses(ts, np.stack(gts))
    ate = traj.absolute_trajectory_error(traj.Trajectory.from_poses(ts, poses), gt)["rmse"]
    still = traj.absolute_trajectory_error(
        traj.Trajectory.from_poses(ts, np.tile(np.eye(4), (len(ts), 1, 1))), gt
    )["rmse"]
    return ate, still


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    from phovo_tpu_torch.models import analytic, autodiff
    from phovo_tpu_torch.models.analytic import align_sequence, align_sequence_chunk, prep_frame_analytic
    from phovo_tpu_torch.ops import _build, se3
    from phovo_tpu_torch.ops import fused as fused_ops
    from phovo_tpu_torch.ops import fused_batch as fb
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.ops.pyramid import level_shape
    from phovo_tpu_torch.utils import trajectory as traj
    from phovo_tpu_torch.utils.config import config_from_dict
    from phovo_tpu_torch.utils.synthetic import make_pair, make_sequence

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

    # 3. kernels vs plain versions at the VGA levels
    cfg_fixed, cfg_ee = bench_config(0.0), bench_config(300.0)
    cfg_tr = config_from_dict(CERES_PRESET)
    I, D, _, _ = make_sequence(TUM_FR1, SHAPE, 9)
    I9, D9 = torch.from_numpy(np.stack(I)).to(dev), torch.from_numpy(np.stack(D)).to(dev)
    prep = prep_frame_analytic(I9, D9, TUM_FR1, cfg_fixed)
    max_err = 0.0
    for sampling in ("nearest", "bilinear"):
        iterations = {
            level: n if sampling == "bilinear" else min(n, NEAREST_ITERATIONS)
            for level, n in enumerate(cfg_fixed.max_iterations)
        }
        max_err = max(max_err, compare_levels(fb, pair_packs(prep), TUM_FR1, iterations, sampling, card))
    tr_packs = pair_packs(prep_frame_analytic(I9, D9, TUM_FR1, cfg_tr))
    tr_err = compare_tr_levels(fb, tr_packs, TUM_FR1, cfg_tr, card)
    del prep, tr_packs

    # 4. the analytic main path: 257 frames through align_sequence_chunk
    t0 = time.perf_counter()
    I, D, gts, ts = make_sequence(TUM_FR1, SHAPE, N_FRAMES)
    I8 = np.round(np.stack(I) * 255.0).astype(np.uint8)
    D16 = np.round(np.stack(D) / DEPTH_SCALE).astype(np.uint16)
    print(f"main path: rendered {N_FRAMES} frames in {time.perf_counter() - t0:.1f} s")

    def run_chain(chunk_fn, cfg):
        carry_i = torch.from_numpy(I8[0]).to(dev)
        carry_d = torch.from_numpy(D16[0]).to(dev).to(torch.float32) * float(np.float32(DEPTH_SCALE))
        parts = []
        for lo, hi in CHUNKS:
            res, carry_i, carry_d = chunk_fn(
                carry_i, carry_d, torch.from_numpy(I8[lo:hi]).to(dev),
                torch.from_numpy(D16[lo:hi]).to(dev), TUM_FR1, cfg,
                depth_scale=DEPTH_SCALE,
            )
            parts.append(res)
        torch.cuda.synchronize()
        return type(parts[0])(*(torch.cat(x) for x in zip(*parts)))

    reset_counts(fb)
    kern = run_chain(align_sequence_chunk, cfg_ee)
    launches, other = fb.LAUNCHES, fb.TR_LAUNCHES
    active = sum(1 for n in cfg_ee.max_iterations if n > 0)
    print(f"main path: kernel launches {launches} (expected {active} levels x {len(CHUNKS)} chunks), "
          f"trust-region launches {other}")
    check(launches == active * len(CHUNKS), "the main path did not launch the kernel at every level of every chunk")
    check(other == 0, "the analytic path launched the trust-region kernel")

    reset_counts(fb)
    with mock.patch.object(analytic, "fused_gn_level_batch", fb.fused_gn_level_batch_reference):
        plain = run_chain(align_sequence_chunk, cfg_ee)
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
    ate, ate_still = trajectory_ate(se3, traj, kern.state, gts, ts)
    print(f"main path: ATE rmse {ate:.6f} m (identity trajectory {ate_still:.6f} m)")
    check(np.isfinite(ate) and ate < ate_still, "ATE not finite or not below standing still")

    # 5. the ceres main path: the same frames, the shipped ceres preset
    t0 = time.perf_counter()
    reset_counts(fb)
    tr_kern = run_chain(autodiff.align_sequence_chunk_autodiff, cfg_tr)
    tr_launches, other = fb.TR_LAUNCHES, fb.LAUNCHES
    wall = time.perf_counter() - t0
    tr_active = sum(1 for n in cfg_tr.max_iterations if n > 0)
    print(f"ceres path: trust-region launches {tr_launches} (expected {tr_active} levels x "
          f"{len(CHUNKS)} chunks), GN launches {other}, {wall:.3f} s")
    check(tr_launches == tr_active * len(CHUNKS), "the ceres path did not launch the trust-region kernel at every level of every chunk")
    check(other == 0, "the ceres path launched the GN kernel")
    reset_counts(fb)
    with mock.patch.object(autodiff, "fused_tr_level_batch", fb.fused_tr_level_batch_reference):
        tr_plain = run_chain(autodiff.align_sequence_chunk_autodiff, cfg_tr)
    check(fb.TR_LAUNCHES == 0, "the plain ceres run launched the kernel")
    err, _ = compare_tr_results(
        tr_kern, tr_plain, f"ceres path: {tr_kern.state.shape[0]} pairs kernel vs plain [{card}]", strict=False,
    )
    tr_err = max(tr_err, err)
    print(f"ceres path: iterations per level (mean) "
          f"{tr_kern.iterations.double().mean(dim=0).cpu().numpy().round(3).tolist()}")
    check(bool(torch.isfinite(tr_kern.state).all()), "non-finite ceres states")
    check(tuple(tr_kern.state.shape) == (N_FRAMES - 1, 6), f"ceres state shape {tuple(tr_kern.state.shape)}")
    ate, ate_still = trajectory_ate(se3, traj, tr_kern.state, gts, ts)
    print(f"ceres path: ATE rmse {ate:.6f} m (identity trajectory {ate_still:.6f} m)")
    check(np.isfinite(ate) and ate < ate_still, "ceres ATE not finite or not below standing still")

    # 6. the per-pair object API and the warm-started chain
    n = N_API_PAIRS + 1
    depth_m = [torch.from_numpy(D16[k]).to(dev).to(torch.float32) * float(np.float32(DEPTH_SCALE)) for k in range(n)]
    Iapi, Dapi = torch.from_numpy(I8[:n]).to(dev), torch.stack(depth_m)
    lm = autodiff.align_sequence_autodiff(Iapi, Dapi, TUM_FR1, cfg_tr)
    vo = autodiff.PhotoconsistencyOdometryAutodiff(cfg_tr, device=dev)
    vo.set_intrinsic_matrix([[TUM_FR1.fx, 0, TUM_FR1.cx], [0, TUM_FR1.fy, TUM_FR1.cy], [0, 0, 1]])
    reset_counts(fb)
    states = []
    for k in range(N_API_PAIRS):
        vo.set_source_frame(I8[k], depth_m[k])
        vo.set_target_frame(I8[k + 1], depth_m[k + 1])
        vo.set_initial_state_vector(np.zeros(6))
        states.append(vo.optimize().state)
    torch.cuda.synchronize()
    api_launches = fb.TR_LAUNCHES
    api_err = float((torch.stack(states) - lm.state).abs().max())
    print(f"per-pair API: {N_API_PAIRS} pairs, trust-region launches {api_launches} "
          f"(expected {tr_active} x {N_API_PAIRS}), max|state diff| vs level-major {api_err:.3e}")
    check(api_launches == tr_active * N_API_PAIRS, "optimize() did not launch once per level per pair")
    check(api_err <= STATE_ATOL, f"per-pair vs level-major state diff {api_err}")
    reset_counts(fb)
    warm = autodiff.align_sequence_autodiff(Iapi, Dapi, TUM_FR1, cfg_tr, warm_start=True)
    torch.cuda.synchronize()
    warm_launches = fb.TR_LAUNCHES
    print(f"warm start: {N_API_PAIRS} pairs, trust-region launches {warm_launches}, "
          f"max|state - zero-init state| {float((warm.state - lm.state).abs().max()):.3e}")
    check(warm_launches == tr_active * N_API_PAIRS, "the warm chain did not launch once per level per pair")
    check(bool(torch.isfinite(warm.state).all()), "non-finite warm-start states")
    with mock.patch.object(fused_ops, "fused_tr_level_batch", fb.fused_tr_level_batch_reference):
        warm_plain = autodiff.align_sequence_autodiff(Iapi, Dapi, TUM_FR1, cfg_tr, warm_start=True)
    check(fb.TR_LAUNCHES == warm_launches, "the plain warm run launched the kernel")
    err, _ = compare_tr_results(
        warm, warm_plain, f"warm start: {N_API_PAIRS} pairs kernel vs plain [{card}]", strict=False,
    )
    tr_err = max(tr_err, err)

    # 7. timing, device-resident frames: the bench.py workload
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
    del packs
    states = torch.zeros((n_pairs, 6), device=dev)
    ms_integrate = cuda_ms(lambda: se3.integrate_trajectory(states), REPEATS)
    print(f"layer integrate ({n_pairs} poses): {ms_integrate:.3f} ms [{card}]")

    # the ceres workload: 256 VGA pairs, the shipped preset
    ms_tr = cuda_ms(lambda: autodiff.align_sequence_autodiff(Is, Ds, TUM_FR1, cfg_tr), 3)
    print(f"ceres workload: {1e3 * n_pairs / ms_tr:.1f} pairs/s ({ms_tr:.3f} ms / {n_pairs} pairs) [{card}]")
    ms_prep = cuda_ms(lambda: prep_frame_analytic(Is, Ds, TUM_FR1, cfg_tr), 3)
    print(f"layer prep, all 5 levels ({N_FRAMES} frames): {ms_prep:.3f} ms [{card}]")
    packs = pair_packs(prep_frame_analytic(Is, Ds, TUM_FR1, cfg_tr))
    tr_kernel_ms = tr_plain_ms = 0.0
    init = torch.zeros((n_pairs, 6), device=dev)
    torch.cuda.reset_peak_memory_stats()
    for level, (i0, geom, t_all) in sorted(packs.items(), reverse=True):
        H, W = level_shape(SHAPE, level)
        args = (i0, geom, t_all, TUM_FR1.at_level(level), init, cfg_tr.trust_region_options(level))
        p1 = cuda_ms(lambda: fb.fused_tr_level_batch_reference(*args, H=H, W=W), 1)
        k1 = cuda_ms(lambda: fb.fused_tr_level_batch(*args, H=H, W=W), 3)
        k2 = cuda_ms(lambda: fb.fused_tr_level_batch(*args, H=H, W=W), 3)
        p2 = cuda_ms(lambda: fb.fused_tr_level_batch_reference(*args, H=H, W=W), 1)
        res = fb.fused_tr_level_batch(*args, H=H, W=W)
        k, p = (k1 + k2) / 2, (p1 + p2) / 2
        tr_kernel_ms += k
        tr_plain_ms += p
        print(f"layer trust-region kernel: level {level} {H}x{W}, {n_pairs} pairs, iterations mean "
              f"{float(res.iterations.double().mean()):.3f} max {int(res.iterations.max())}: "
              f"kernel {k:.3f} ms ({k1:.3f}, {k2:.3f}), plain {p:.3f} ms ({p1:.3f}, {p2:.3f}) [{card}]")
        init = res.state
    print(f"trust-region timing: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del packs

    # the per-pair route: one VGA pair, one launch (B = 1) a level
    pair = (Is[0], Ds[0], Is[1], Ds[1], TUM_FR1, torch.zeros(6, device=dev), cfg_tr)
    ms_pair = cuda_ms(lambda: autodiff.align_autodiff(*pair), 3)
    one = pair_packs(prep_frame_analytic(Is[:2], Ds[:2], TUM_FR1, cfg_tr))[0]
    ms_one = cuda_ms(lambda: fb.fused_tr_level_batch(
        *one, TUM_FR1, torch.zeros((1, 6), device=dev), cfg_tr.trust_region_options(0),
        H=SHAPE[0], W=SHAPE[1]), 3)
    print(f"per-pair route: align_autodiff {ms_pair:.3f} ms a VGA pair; its 480x640 level "
          f"(B = 1, one SM) {ms_one:.3f} ms [{card}]")

    record = {"kernels": [
        {
            "name": "fused_gn_level_batch",
            "route": "cuda",
            "source": "phovo_tpu_torch/csrc/fused_gn_batch.cu",
            "replaces": "phovo_tpu/ops/fused_batch.py:607",
            "launches": launches,
            "max_abs_err": max_err,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
        },
        {
            "name": "fused_tr_level_batch",
            "route": "cuda",
            "source": "phovo_tpu_torch/csrc/fused_tr_batch.cu",
            "replaces": "phovo_tpu/ops/fused_batch.py:922 and phovo_tpu/ops/fused.py:1011",
            "launches": tr_launches,
            "max_abs_err": tr_err,
            "ms": tr_kernel_ms,
            "plain_ms": tr_plain_ms,
        },
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
