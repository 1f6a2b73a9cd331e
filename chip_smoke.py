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
 3b. the variants vs plain: the GN kernel with huber, cauchy, tukey, ESM
     and the Student-t loss (its sigma carried level to level, with the
     burn-in) at every active level of the analytic preset, both
     samplings, plus 3 iterations at 480x640 and 240x320 (bilinear costs
     within 1e-4; a nearest cost difference split into the order of the
     sums, within 1e-4, and named sample flips) and one linearization
     there; the trust-region kernel with huber, cauchy and tukey at all
     five ceres levels (a valid count that differs must be accounted for
     by pixels at the image edge); the one-linearization kernel's Gram at
     every VGA level for each variant
 6b. per-pair analytic API: 4 pairs through
     PhotoconsistencyOdometryAnalytic.optimize() with the analytic preset,
     one GN launch per pair per active level, and the warm-started chain,
     each once more through the plain version; one 480x640 pair of
     config_only_level_0_analytic
 6c. robust losses on an occluded VGA pair (tests/test_robust.py's
     occluder scaled to VGA): each loss cuts the error of 'none'
 6d. per-linearization API: one VGA pair solved by gauss_newton_level over
     make_fused_linearizer (one launch of the one-linearization kernel per
     iteration), against align_analytic on the GN kernel; each level's
     Gram at its end state, at the rule's split (lin_split), against the
     plain version
 7b. timing: the per-pair analytic route, the 256-pair analytic chain with
     huber, tdist and ESM beside 'none', the ceres chain with huber, the
     GN kernel at B = 1 at 480x640 and the one-linearization kernel at
     B = 1 and 16 at every VGA level (through its C entry, and through
     the wrapper), each against its plain version
 3c. the inverse-compositional kernels vs plain: K-ICpre on 8 VGA frames
     at all five levels (rows within 1e-6, the factor within 1e-4 of its
     largest entry); K-IC on 8 VGA pairs at every active level of the
     bench schedule, bilinear over the whole schedule, nearest over 3
     iterations, and an early-exit case per sampling; their cluster
     layout: K-IC on one pair at 480x640 and 240x320 (streamed, in
     clusters) and K-ICpre on one 480x640 frame against plain, every
     cluster size (1-16) against one block a pair and a resident pack
     against a streamed one (the same bits) at every level, and pairs and
     frames alone against their 256-pair and 257-frame launches at
     480x640, 120x160 and 60x80 (the same bits)
 4b. IC main path: the 257 frames through align_sequence_chunk_ic in the
     two chunks, early exit at 300 and fixed-75: launch counts, kernel vs
     plain, the ATE
 6e. IC object API: 4 pairs through PhotoconsistencyOdometryIC.optimize()
     against the level-major chain; one 480x640 pair of
     config_only_level_0_analytic
 7c. IC timing: the IC chain beside the analytic chain (fixed-75, early
     exit), the IC prep layer, K-ICpre and K-IC per level through their C
     entries vs their plain versions, at 256 pairs (257 frames) on the
     bench levels and at B = 1 on all five, each with its bound, cluster
     size and residency, align_ic a VGA pair
 3d. the bi-objective level kernel (K-GN-bi) vs plain: 8 VGA pairs at all
     five levels with 'none', huber, cauchy and tukey: bilinear over the
     bench schedule's iterations (3 at 480x640 and 240x320), nearest over
     3 iterations with the cost held and split by attribute_nearest_cost,
     and per level and sampling an early-exit case from zero
 4c. bi-objective main path: the 257 frames through
     align_sequence_chunk_biobjective in the two chunks, early exit at 300
     and fixed-75: launch counts, kernel vs plain, the ATE beside the
     analytic chain's
 6f. bi-objective object API: 4 pairs through
     PhotoconsistencyOdometryBiObjective.optimize() with the analytic
     preset against the level-major chain and the plain version; the
     warm-started chain; one 480x640 pair of config_only_level_0_analytic
 7d. bi-objective timing: the bi chain beside the analytic chain
     (fixed-75, early exit), the bi prep layer, K-GN-bi per level vs its
     plain version and vs K-GN on the same frames, K-GN-bi at B = 1 on a
     480x640 level, align_biobjective a VGA pair
 3e. the shared-source modes (keyframe tracking) and the multi-stream
     level vs plain: K-GN with one keyframe's pack shared by 8 VGA
     targets at every active level of the analytic preset ('none', huber,
     tukey, ESM; bilinear over the schedule, nearest over 3 iterations
     with the cost split by attribute_nearest_cost), K-TR shared at the
     five ceres levels with its early-exit cases, each shared launch
     against the replicated launch (the same bits), and
     fused_gn_level_multi at S = 8 against its plain version and K-GN
 4d. keyframe main path: 64 VGA frames of an out-and-back loop through
     KeyframeVisualOdometry.run_chunked (chunk 16, uint16 depth counts)
     and finalize(), analytic and ceres presets, once through the kernels
     and once through the plain versions: at least 3 keyframes and a
     closure, the launch counts, the same keyframes, edges and closures,
     the ATE against standing still and the frame chain's
 4e. serving: the 257 frames as 8 streams of 33 through align_sequences,
     serve_sequences_chunk (two chunks) and align_sequences_multi: counts,
     kernel vs plain, the flatten against each stream's own chain
 4f. the CLIs, in process (main(argv)): 33 synthetic VGA frames written in
     the raw layout (datasets/raw.py) with their ground truth, the 12
     shipped presets read by the port's own reader (no pyyaml);
     phovo-vo --chunk 16 for analytic, ceres, ic and biobjective (each
     trajectory the in-process align_sequence_chunk* chain's lines, bit
     for bit), frame mode over 7 pairs, --mode keyframe (analytic),
     phovo-serve with 2 streams (each its own phovo-vo --chunk lines) and
     phovo-eval --json; each ATE below standing still, each run's kernel
     launches counted from 0, pairs/s per CLI, and whether the libpng
     loader loads (information); the difference images: frame mode with
     --save-diff-dir (one PNG a pair) and phovo-align on .npy frames with
     --save-diff and --save-diff-dir (visualize_iterations on: one PNG a
     replayed iteration, K-LIN launched once an iteration), each PNG
     decoded with zlib and equal to alignment_diff's image
 7e. timing: the keyframe path's frames/s with its dispatches, closures
     and finalize apart, align_sequences beside align_sequence on the same
     256 pairs, align_sequences_multi a time step, and per level K-GN
     shared vs replicated, K-TR shared and fused_gn_level_multi (on
     prebuilt packs, the packing wrapper beside it) vs plain
 7f. the cluster layout: per level, K-TR and K-GN at the rule's cluster
     size (ops/fused_batch.py::cluster_size) against one block a pair,
     through their C entries: K-TR at B = 1, 16 shared targets and 256
     pairs, K-GN at B = 1, 16 shared targets and 256 pairs, K-GN-bi at
     B = 1 and 256 pairs
 4g. the keyframe back-end: 48 VGA frames of the room (render_room along
     make_room_sequence's forward sweep) in the raw layout through
     phovo-vo --mode keyframe --chunk 16 (the analytic preset) without
     bundle adjustment, with --ba-iterations 3, and with --ba-iterations 3
     --ba-scope global --export-map: each trajectory the in-process
     run_chunked + finalize lines bit for bit, BA(3)'s ATE below the pose
     graph's alone, the PLY's vertex count the map's, the back-end
     launching no kernel, the same refinement twice the same bits, and the
     windowed (dense, and on the sparse Schur path) and global refinements
     on the card against the CPU's from the same keyframes at damping 1.0
 7g. the back-end's times: finalize's pg_solve and photometric_ba, window
     and global, on phase 4g's keyframes; optimize_photometric_bundle
     dense and sparse on one global problem of 64 VGA room keyframes (P =
     4,096, K = 24,576), and the two held together at damping 1.0;
     optimize_bundle sparse and dense at map scale
     (128 poses, 50,000 landmarks, 102,400 observations)
 4h. the iteration trace: utils/trace.trace_alignment on one VGA pair
     (bilinear, the analytic preset's budgets in full), 'warped', 'esm' and
     the Student-t loss, through K-LIN and again with the linearizer forced
     to its plain version: the same records, states within 2e-4, valid
     counts equal or accounted for by edge pixels, K-LIN launched once a
     record (and once a burn-in step)
 4i. tools/parity_harness_torch on the cluttered scene (240x320, 10
     frames), every shipped preset, the port on the card against the
     reference-exact oracle on the host, written to
     artifacts/parity_torch_cluttered_qvga.md and .json
 4j. the mesh forms (parallel/mesh.py): make_data_parallel_aligner on the
     256 main-path pairs and on 255 of them (K-GN), make_chunked_sequence_
     server on phase 4e's 8 streams (K-GN), make_pixel_sharded_aligner on
     one VGA pair, finalize(mesh=) on phase 4g's keyframes with BA(3)
     window and global at damping 1.0, optimize_bundle(mesh=) at map
     scale: unsharded, then one rank in an NCCL group, then two ranks
     spawned over gloo sharing the card (data = 2, and pixel = 2 for the
     pixel aligner), the library built before they start. The data axis
     gives the unsharded bits with K-GN launched on each rank, the
     all-reduced forms agree within 1e-5 (finalize: its keyframe poses,
     its map the same size), and phovo-serve --devices 2 in the two ranks
     writes the one-process trajectories
 6g. the ceres backend's jacfwd Jacobian on one VGA pair against the
     linearizer mode (within 5e-3), ms a pair of each
 7h. profiler windows (utils/profiling.trace): kernel launches,
     device-busy and wall ms of one serving step (align_sequences_multi, 8
     streams) and of one LM iteration of finalize's photometric bundle
     adjustment (phase 4g's global keyframes)
 7i. K-PREP (csrc/prep_levels.cu) on the main paths' chunk of 257 VGA
     frames (a float32 carry, then uint8 intensity and uint16 depth
     counts) with the ceres preset (five levels) and the analytic preset
     (levels 2-4): its packs and carry equal to the torch chain's, one
     launch a call, its time beside its bound (bytes once at 3.35 TB/s)
     and the torch chain's; then, under a profiler window, the kernel
     launches of a chunk of each backend and of one object-API ceres pair,
     with K-PREP's launches and the torch chain's calls
Each of the paths of phases 4, 4b, 4c, 4d, 4e, 4f (each CLI run), 4g (each
CLI run), 4h (each trace), 4j (each form on each rank), 5, 6, 6b, 6d, 6e and
6f runs with the launch
counts set to 0 just before it and read just after. A line
"[t s] phase" marks each phase's start. The line before the last is the
kernels' JSON record (for fused_lin, max_abs_err is the largest Gram
difference over the Gram's largest entry; bound_ms is the least time the
card could take for the timed work, from the bytes it must move and the
float32 operations it does; cluster is the blocks a pair by level of the
timed work; K-LIN's split is its blocks a pair by level, and by_level its
times at B = 1 and 16; K-IC's resident says by level whether its pack
stays in shared memory; cli_launches counts each kernel's launches under
each CLI run of phase 4f; K-LIN's trace_launches its launches under each
trace of phase 4h; K-GN's mesh_launches its launches under each form of
phase 4j by rank); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import subprocess
import sys
import time
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch

SHAPE = (480, 640)
DEPTH_SCALE = 1.0 / 5000.0  # TUM 16-bit depth counts
N_FRAMES = 257  # 256 pairs, as bench.py
CHUNKS = ((1, 129), (129, 257))  # frame ranges of the two chunks
STATE_ATOL = 2e-4  # tests/test_fused_batch.py's level for the batch kernel
# Costs are float32 sums of r^2 >= 0. The kernel sums 150 pixels a thread
# at 480x640 (8 blocks a pair) before its shuffle, warp and cluster
# passes, so the standard bound on such a sum (Higham's gamma_n, n = 169
# additions) is 1.0e-5 of the cost on its side alone; torch's tree
# reduction adds its own. With one block a pair (1,200 pixels a thread,
# n = 1,211, 7.2e-5) the reading there was 9.675e-5 on every run (both
# sums are deterministic); 1e-4 is kept as the bound
# tests/test_fused_batch.py pins for the TPU kernels. It holds
# one linearization's cost at the same state, and bilinear runs. A nearest
# run's cost moves by a whole pixel's residual once a sample flips between
# the two versions' states (3 iterations at 240x320: 1.070e-4 huber,
# 1.412e-4 tukey, 1.452e-4 tdist; H100), so attribute_nearest_cost holds
# its part from the order of the sums to this bound and names the flips.
COST_RTOL = 1e-4
# The Student-t sigma out, kernel vs plain: sqrt(cost / n), so half the
# cost's relative difference, at COST_RTOL's level.
SIGMA_RTOL = 1e-4
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
# The shipped analytic presets phovo_tpu/configs/config_5_level_optimization_
# analytic.yml and config_only_level_0_analytic.yml as YAML mappings;
# tests/test_torch_analytic.py holds them to the files.
ANALYTIC_PRESET = {
    "num_levels": 5,
    "blur_filter_sizes": [0, 0, 0, 0, 0],
    "gradient_scales": [0.0625] * 5,
    "lambda_steps": [1, 1, 1, 1, 1],
    "max_iterations": [0, 0, 5, 20, 50],
    "min_gradient_norms": [300] * 5,
    "visualize_iterations": False,
}
LEVEL0_PRESET = {
    "num_levels": 1,
    "blur_filter_sizes": [0],
    "gradient_scales": [0.0625],
    "lambda_steps": [1],
    "max_iterations": [5000],
    "min_gradient_norms": [300],
    "visualize_iterations": True,
}
# The loss scales of tests/test_robust.py:117-118, and the Student-t seed.
LOSS_DELTAS = {"huber": 0.02, "cauchy": 0.02, "tukey": 0.1, "tdist": 0.1}
GN_VARIANTS = ("huber", "cauchy", "tukey", "esm", "tdist")
# The trust-region variants' strict cases may end with valid counts a pixel
# apart: states 1e-7 apart can put one pixel's warped u or v on the two
# sides of the in-bounds edge (huber at 480x640 after 3 iterations from
# zero: one pixel of 307,200 on one of 8 pairs; H100). Such a difference
# passes only where explain_valid_diff accounts for it pixel by pixel, and
# an edge pixel moves by no more than this many pixels between the states.
EDGE_SHIFT_PX = 1e-3
# The one-linearization kernel's Gram against its plain version: float32
# sums over up to 307,200 pixels in another order, relative to the
# Gram's largest entry.
GRAM_RTOL = 1e-4
# tests/test_robust.py's occluder (rows 10.., cols 20.. of 96x128, 22% of
# the height, 44% of the width, 0.95) and its bounds on the pose error
# (:117-128, :221-241): (loss, delta, bound, the factor it cuts 'none' by)
OCCLUSION_CASES = (
    ("huber", 0.02, 0.4, 3), ("cauchy", 0.02, 0.06, 3), ("tukey", 0.1, 0.06, 3),
    ("tdist", 0.1, 0.15, 4),
)
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


def timing_frames(dev):
    """The timing workloads' N_FRAMES VGA frames on the card: make_pair's
    two frames alternated (bench.py's workload), (intensities, depths)."""
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.utils.synthetic import make_pair

    I0, D0, I1, D1, _ = make_pair(TUM_FR1, SHAPE)
    Is = torch.from_numpy(np.stack([I0, I1] * ((N_FRAMES + 1) // 2))[:N_FRAMES]).to(dev)
    Ds = torch.from_numpy(np.stack([D0, D1] * ((N_FRAMES + 1) // 2))[:N_FRAMES]).to(dev)
    return Is, Ds


def pair_packs(prep: dict) -> dict:
    """Per-frame packs -> per-pair packs (source k, target k+1): the
    source's (i0, geom) and the target's t_all and, for the bi-objective
    level, its depth gain."""
    return {
        level: (i0[:-1], geom[:-1], *(x[1:] for x in target))
        for level, (i0, geom, *target) in prep.items()
    }


def reset_counts(fb) -> None:
    """Every kernel wrapper's launch count to 0."""
    from phovo_tpu_torch.ops import fused
    from phovo_tpu_torch.ops import ic as IC
    from phovo_tpu_torch.ops import ic_batch as ICB

    fb.LAUNCHES = 0
    fb.TR_LAUNCHES = 0
    fb.LIN_LAUNCHES = 0
    fb.SHARED_LAUNCHES = 0
    fb.TR_SHARED_LAUNCHES = 0
    fb.BI_LAUNCHES = 0
    fused.MULTI_LAUNCHES = 0
    reset_ic_counts(IC, ICB)


def launch_counts(fb) -> dict:
    """Every kernel wrapper's launch count, by kernel."""
    from phovo_tpu_torch.ops import fused
    from phovo_tpu_torch.ops import ic as IC
    from phovo_tpu_torch.ops import ic_batch as ICB

    return {"K-GN": fb.LAUNCHES, "K-GN shared": fb.SHARED_LAUNCHES, "K-GN-bi": fb.BI_LAUNCHES,
            "K-GN multi": fused.MULTI_LAUNCHES, "K-TR": fb.TR_LAUNCHES, "K-TR shared": fb.TR_SHARED_LAUNCHES,
            "K-ICpre": IC.IC_PRE_LAUNCHES, "K-IC": ICB.IC_LAUNCHES, "K-LIN": fb.LIN_LAUNCHES}


def shared_note(i0, t_all) -> str:
    """' (one shared source)' when a level's packs share one source."""
    return " (one shared source)" if i0.shape[0] == 1 and t_all.shape[0] > 1 else ""


def variant_config(cfg, variant: str):
    """cfg with one variant: 'none', 'esm' (gradient_at) or a robust loss
    at its LOSS_DELTAS scale."""
    if variant == "esm":
        return dataclasses.replace(cfg, gradient_at="esm")
    if variant == "none":
        return cfg
    return dataclasses.replace(cfg, robust_loss=variant, robust_delta=LOSS_DELTAS[variant])


def gn_variant_kw(cfg) -> dict:
    """The level kernels' variant arguments of a config."""
    return dict(robust_loss=cfg.robust_loss, robust_delta=cfg.robust_delta, esm=cfg.gradient_at == "esm")


def warped_uv(fb, geom, states, intr, H, W, sampling):
    """Each pixel's warped (u, v) and valid flag, (B, N) each, at states
    (B, 6), in the plain version's order of operations
    (fused_batch._pixel_columns), so the same bits as it computes."""
    fx, fy, cx, cy = intr
    px, py, pz, vd = geom.unbind(1)[:4]
    s = [states[:, k:k + 1] for k in range(6)]
    (R00, R01, R02, R10, R11, R12, R20, R21, R22), *_ = fb._rotation_terms(s[3], s[4], s[5])
    tx = R00 * px + R01 * py + R02 * pz + s[0]
    ty = R10 * px + R11 * py + R12 * pz + s[1]
    tz = R20 * px + R21 * py + R22 * pz + s[2]
    iz = 1.0 / torch.where(torch.abs(tz) > 1e-12, tz, torch.full_like(tz, 1e-12))
    u = tx * fx * iz + cx
    v = ty * fy * iz + cy
    valid = (vd > 0.5) & (tz > 0)
    if sampling == "bilinear":
        return u, v, valid & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    c0, r0 = torch.round(u), torch.round(v)
    return u, v, valid & (c0 >= 0) & (c0 <= W - 1) & (r0 >= 0) & (r0 <= H - 1)


def attribute_nearest_cost(fb, args, kw, k, p, what, card):
    """Where the cost difference of a nearest GN run of n >= 2 fixed
    iterations (k kernel, p plain) comes from. Its cost is the last
    linearization's, at the state after n - 1 iterations. Nearest residuals
    are piecewise constant in the state: at two states whose every sample
    is the same pixel, the plain version's cost at one scale is the same
    bits. So the difference is
      the order of the sums: the kernel's cost against the plain version's
        at the kernel's own state and scale, held to COST_RTOL;
      plus sample flips: pixels whose nearest sample or validity differs
        between the two versions' states after 1..n-1 iterations.
    Checks the first; that, but for 'tdist' (whose sigma carries the
    earlier linearizations' flips) and the bi-objective level (whose depth
    residual gain (D - tz) moves with the state through tz), the plain
    costs at the two last states are the same bits on every pair without
    a flip there; that every pair whose cost differs by more than
    COST_RTOL has a flip; and that the valid counts differ by exactly the
    pixels whose validity flips between the two last states. Prints the
    worst pair's flips, with one pixel named."""
    i0, geom, t_all, intr, init, n = args[:6]
    H, W = kw["H"], kw["W"]

    def rel(a, b):
        return (a - b).abs() / b.abs().clamp_min(1e-30)

    flips, coords = [], []  # after m = 1..n-1 iterations: (B, N) flags, (u, v) of both
    for m in range(1, n):
        km = fb.fused_gn_level_batch(*args[:5], m, *args[6:], **kw)
        pm = fb.fused_gn_level_batch_reference(*args[:5], m, *args[6:], **kw)
        uk, vk, ok = warped_uv(fb, geom, km.state, intr, H, W, "nearest")
        up, vp, op = warped_uv(fb, geom, pm.state, intr, H, W, "nearest")
        moved = (torch.round(uk) != torch.round(up)) | (torch.round(vk) != torch.round(vp))
        flips.append((ok != op) | (ok & op & moved))
        coords.append((uk, vk, up, vp))
    nv_flips = (ok.sum(dim=1) - op.sum(dim=1)).to(k.num_valid.dtype)  # at the last linearization
    # km, pm: the states and scales of the last linearization
    same_kw = dict(kw, robust_scale=km.robust_scale, tdist_burnin=0)
    at_k = fb.fused_gn_level_batch_reference(i0, geom, t_all, intr, km.state, 1, *args[6:], **same_kw).cost
    torch.cuda.synchronize()
    same, total = rel(k.cost, at_k), rel(k.cost, p.cost)
    n_last = flips[-1].sum(dim=1)
    n_any = torch.stack(flips).any(dim=0).sum(dim=1)
    b = int(total.argmax())
    named = "no flip"
    for m in range(n - 1, 0, -1):
        idx = flips[m - 1][b].nonzero()
        if idx.numel():
            j = int(idx[0])
            uk, vk, up, vp = (float(c[b, j]) for c in coords[m - 1])
            named = (f"{int(flips[m - 1][b].sum())} flipped after {m} it, e.g. pixel (row {j // W}, col {j % W}): "
                     f"u, v kernel ({uk:.6f}, {vk:.6f}), plain ({up:.6f}, {vp:.6f})")
            break
    print(f"nearest cost attribution {what}: cost rel diff {float(total.max()):.3e}, of which the order of "
          f"the sums (plain at the kernel's state) {float(same.max()):.3e}; flipped samples per pair at the "
          f"last linearization {n_last.tolist()}, at any {n_any.tolist()}; worst pair {b}: {named} [{card}]")
    check(float(same.max()) <= COST_RTOL, f"{what}: same-state cost rel diff {float(same.max())} > {COST_RTOL}")
    if kw.get("robust_loss") != "tdist" and kw.get("depth_gains") is None:
        unflipped = n_last == 0
        check(torch.equal(at_k[unflipped], p.cost[unflipped]),
              f"{what}: plain costs at the two states differ on a pair without a flipped sample")
    check(bool((n_any[total > COST_RTOL] > 0).all()),
          f"{what}: a pair's cost differs by more than {COST_RTOL} without a flipped sample")
    nv_diff = k.num_valid - p.num_valid
    if bool(nv_diff.any()):
        print(f"nearest valid counts {what}: kernel minus plain {nv_diff.tolist()}, pixels whose validity flips "
              f"between the last states {nv_flips.tolist()} [{card}]")
    check(torch.equal(nv_flips, nv_diff), f"{what}: valid counts differ by more than the flipped pixels")


def compare_levels(fb, packs, intr, iterations, sampling, card, cfg=None, check_cost=False, attribute=False,
                   explain_edge=False):
    """GN kernel vs plain version on the same packs at every active level,
    `iterations[level]` fixed iterations from the zero state, with cfg's
    variant (gn_variant_kw; none without cfg). With 'tdist' the first
    level runs the burn-in from the seed and each later level starts from
    the kernel's sigma of the level before, in both versions, whose sigmas
    out must agree within SIGMA_RTOL (bilinear, or one linearization:
    after a few nearest iterations a sample flip moves sigma as it moves
    the cost). check_cost: costs within COST_RTOL. attribute (nearest,
    2 or more iterations): attribute_nearest_cost, which then holds the
    valid counts too. explain_edge (bilinear):
    valid counts may differ where explain_valid_diff accounts for it at
    the states of the last linearization.
    Returns (the largest state difference, the largest cost rel diff)."""
    from phovo_tpu_torch.ops.pyramid import level_shape
    from phovo_tpu_torch.ops.robust import TDIST_BURNIN

    vkw = {} if cfg is None else gn_variant_kw(cfg)
    tdist = vkw.get("robust_loss") == "tdist"
    name = "none" if cfg is None else (cfg.robust_loss if cfg.robust_loss != "none" else ("esm" if vkw["esm"] else "none"))
    worst = worst_cost = 0.0
    sigma = None
    for level, (i0, geom, t_all, *gains) in sorted(packs.items(), reverse=True):
        H, W = level_shape(SHAPE, level)
        args = (
            i0, geom, t_all, intr.at_level(level),
            torch.zeros((t_all.shape[0], 6), device=i0.device),
            iterations[level], 0.0, 1.0,
        )
        kw = dict(H=H, W=W, sampling=sampling, **vkw)
        if gains:  # the bi-objective level (K-GN-bi)
            kw["depth_gains"] = gains[0]
            name = f"bi-objective {cfg.robust_loss}"
        if tdist:
            kw.update(robust_scale=sigma, tdist_burnin=TDIST_BURNIN if sigma is None else 0)
        k = fb.fused_gn_level_batch(*args, **kw)
        p = fb.fused_gn_level_batch_reference(*args, **kw)
        torch.cuda.synchronize()
        err = float((k.state - p.state).abs().max())
        cost_rel = float(((k.cost - p.cost).abs() / p.cost.abs().clamp_min(1e-30)).max())
        worst = max(worst, err)
        worst_cost = max(worst_cost, cost_rel)
        same_its = torch.equal(k.iterations, p.iterations)
        same_nv = torch.equal(k.num_valid, p.num_valid)
        extra = ""
        if tdist:
            sig_rel = float(((k.robust_scale - p.robust_scale).abs() / p.robust_scale).max())
            extra = f", sigma rel diff {sig_rel:.3e} (sigma {k.robust_scale.min():.4g}..{k.robust_scale.max():.4g})"
            if sampling == "bilinear" or check_cost:  # nearest flips move it past one linearization
                check(sig_rel <= SIGMA_RTOL, f"{name}: sigma rel diff {sig_rel} > {SIGMA_RTOL}")
            sigma = k.robust_scale
        print(
            f"kernel vs plain{'' if cfg is None else ' ' + name}: level {level} {H}x{W} {sampling} "
            f"{t_all.shape[0]} pairs{shared_note(i0, t_all)} x {iterations[level]} it: "
            f"max|state diff| {err:.3e}, iterations equal {same_its}, "
            f"nvalid equal {same_nv}, max cost rel diff {cost_rel:.3e}{extra} [{card}]"
        )
        check(err <= STATE_ATOL, f"state diff {err} > {STATE_ATOL}")
        if not same_nv and explain_edge and sampling == "bilinear" and same_its:
            explain_gn_valid_diff(fb, args, kw, k, p, f"kernel vs plain {name}: level {level} {H}x{W} bilinear")
            same_nv = True
        # with attribute, attribute_nearest_cost holds the valid counts
        check(same_its and (same_nv or attribute), "iterations or valid counts differ")
        if check_cost:
            check(cost_rel <= COST_RTOL, f"{name}: cost rel diff {cost_rel} > {COST_RTOL}")
        if attribute:
            attribute_nearest_cost(fb, args, kw, k, p, f"{name}: level {level} {H}x{W} "
                                   f"{t_all.shape[0]} pairs{shared_note(i0, t_all)} x {iterations[level]} it", card)
    return worst, worst_cost


def compare_lin(fb, packs, intr, cfg, sampling, card):
    """One-linearization kernel vs plain Gram at every level of packs, at
    seeded small states, with cfg's variant: within GRAM_RTOL of each
    pair's largest entry, valid counts and the band slot equal. Returns
    the largest relative difference."""
    from phovo_tpu_torch.ops.pyramid import level_shape

    vkw = gn_variant_kw(cfg)
    worst = 0.0
    for level, (i0, geom, t_all) in sorted(packs.items(), reverse=True):
        H, W = level_shape(SHAPE, level)
        g = torch.Generator().manual_seed(level)
        states = (torch.randn((i0.shape[0], 6), generator=g) * 1e-3).to(i0.device)
        args = (i0, geom, t_all, intr.at_level(level), states)
        kw = dict(H=H, W=W, sampling=sampling, **vkw)
        k = fb.fused_lin_batch(*args, **kw)
        p = fb.fused_lin_batch_reference(*args, **kw)
        torch.cuda.synchronize()
        rel = float(((k - p).abs() / p.abs().amax(dim=(1, 2), keepdim=True)).max())
        worst = max(worst, rel)
        same_nv = torch.equal(k[:, 7, 7], p[:, 7, 7])
        print(f"one-linearization kernel vs plain ({cfg.robust_loss}, esm {vkw['esm']}, {sampling}): "
              f"level {level} {H}x{W} {i0.shape[0]} pairs: max Gram diff / largest entry {rel:.3e}, "
              f"nvalid equal {same_nv} [{card}]")
        check(rel <= GRAM_RTOL, f"Gram rel diff {rel} > {GRAM_RTOL}")
        check(same_nv and float(k[:, 6, 7].abs().sum()) == 0.0, "Gram valid counts or band slot differ")
    return worst


def stop_values(fb, args, opts, H, W, sampling="bilinear", **loss_kw):
    """What each trust-region stopping test compares with its tolerance,
    per pair, after 0..opts.max_iterations iterations of the plain version
    with every test off: {option name: (iterations + 1, B) float64}. The
    gradient test reads max|J^T r| at the state; the function test
    |dcost| / cost of the step; the parameter test ||step|| against
    ptol (||x|| + ptol), given here as the ptol that just stops it. The
    step tests read accepted steps only: NaN elsewhere and at iteration 0."""
    off = opts._replace(**TR_TESTS_OFF)
    runs = [
        fb.fused_tr_level_batch_reference(*args, off._replace(max_iterations=n), H=H, W=W, sampling=sampling, **loss_kw)
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


def explain_valid_diff(fb, geom, intr, H, W, k, p, what):
    """Trust-region kernel (k) and plain (p) results whose valid counts
    differ: the pixels valid at one version's final state and not at the
    other's, by the plain arithmetic at both states (warped_uv), must give
    every pair's count difference exactly, and each must have its u or v on
    the two sides of the in-bounds edge (0 <= u < W, 0 <= v < H), moved by
    at most EDGE_SHIFT_PX between the states. Prints each such pixel."""
    uk, vk, ok = warped_uv(fb, geom, k.state, intr, H, W, "bilinear")
    up, vp, op = warped_uv(fb, geom, p.state, intr, H, W, "bilinear")
    torch.cuda.synchronize()
    explained = (ok.sum(dim=1) - op.sum(dim=1)).to(torch.float32)
    for b, j in (ok != op).nonzero().tolist():
        cu, cv = (float(c[b, j]) for c in (uk, vk))
        pu, pv = (float(c[b, j]) for c in (up, vp))
        u_edge = ((cu >= 0) != (pu >= 0)) or ((cu < W) != (pu < W))
        v_edge = ((cv >= 0) != (pv >= 0)) or ((cv < H) != (pv < H))
        shift = max(abs(cu - pu), abs(cv - pv))
        print(f"{what}: pair {b} pixel (row {j // W}, col {j % W}) valid in the "
              f"{'kernel' if bool(ok[b, j]) else 'plain version'} only: u kernel {cu:.7f} plain {pu:.7f}, "
              f"v kernel {cv:.7f} plain {pv:.7f} ({W}x{H} edge crossed by {'u' if u_edge else ''}"
              f"{'v' if v_edge else ''}, shift {shift:.3e} px)")
        check((u_edge or v_edge) and shift <= EDGE_SHIFT_PX,
              f"{what}: pixel {j} of pair {b} changes validity away from the in-bounds edge")
    check(torch.equal(explained, k.num_valid - p.num_valid),
          f"{what}: valid counts differ by {(k.num_valid - p.num_valid).tolist()}, the edge pixels "
          f"account for {explained.tolist()}")


def explain_gn_valid_diff(fb, args, kw, k, p, what):
    """GN kernel (k) and plain (p) results of one run (args, kw) with equal
    iteration counts and differing valid counts: the counts are the last
    linearization's, at each pair's state one iteration before its end,
    so explain_valid_diff (bilinear) must account for them at those
    states; nearest, the pixels whose rounded sample changes validity
    between them must."""
    i0, geom, t_all, intr, init, n, threshold, lam = args
    ks, ps = k.state.clone(), p.state.clone()
    for m in k.iterations.unique().tolist():
        sel = k.iterations == m
        before = (i0, geom, t_all, intr, init, m - 1, threshold, lam)
        ks[sel] = fb.fused_gn_level_batch(*before, **kw).state[sel]
        ps[sel] = fb.fused_gn_level_batch_reference(*before, **kw).state[sel]
    H, W = kw["H"], kw["W"]
    if kw["sampling"] == "bilinear":
        explain_valid_diff(fb, geom, intr, H, W, k._replace(state=ks), p._replace(state=ps), what)
        return
    ok = warped_uv(fb, geom, ks, intr, H, W, "nearest")[2]
    op = warped_uv(fb, geom, ps, intr, H, W, "nearest")[2]
    flips = (ok.sum(dim=1) - op.sum(dim=1)).to(k.num_valid.dtype)
    print(f"{what}: valid counts kernel minus plain {(k.num_valid - p.num_valid).tolist()}, pixels whose validity "
          f"flips between the last states {flips.tolist()}")
    check(torch.equal(flips, k.num_valid - p.num_valid), f"{what}: valid counts differ by more than the flipped pixels")


def compare_tr_results(k, p, what, strict, settled=None, explain_valid=None):
    """Trust-region kernel vs plain results of B pairs. Always: states
    within STATE_ATOL, and costs within COST_RTOL on the pairs whose
    iteration counts agree. settled, a (B,) mask of the pairs short of
    convergence: max|J^T r| within GNORM_RTOL there. strict: iteration and
    valid counts equal too, where explain_valid(k, p), when given, may
    account for differing valid counts instead. Otherwise (the shipped
    tolerances, where |dcost| <= ftol cost on float32 sums taken in
    different orders can flip by one iteration) the differing pairs are
    counted and printed. Returns (max state diff, pairs whose iterations
    differ)."""
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
        check(n_its == 0, f"{what}: iterations differ")
        if n_nv and explain_valid is not None:
            explain_valid(k, p)
        else:
            check(n_nv == 0, f"{what}: valid counts differ")
    return err, n_its


def compare_tr_levels(fb, packs, intr, cfg, card, explain_edge=False):
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
    explain_edge: a strict case's valid counts may differ where
    explain_valid_diff accounts for it. Returns the largest state
    difference."""
    from phovo_tpu_torch.ops.pyramid import level_shape

    loss_kw = dict(robust_loss=cfg.robust_loss, robust_delta=cfg.robust_delta)
    worst = 0.0
    init = None
    for level, (i0, geom, t_all) in sorted(packs.items(), reverse=True):
        H, W = level_shape(SHAPE, level)
        if init is None:
            init = torch.zeros((t_all.shape[0], 6), device=i0.device)
        args = (i0, geom, t_all, intr.at_level(level), init)
        opts = cfg.trust_region_options(level)
        B = t_all.shape[0]
        cases = [("budget", args, opts._replace(**TR_TESTS_OFF), None), ("preset", args, opts, None)]
        early = opts._replace(max_iterations=EARLY_EXIT_ITERATIONS, **TR_TESTS_OFF)
        zero = args[:-1] + (torch.zeros_like(init),)
        for name, values in stop_values(fb, zero, early, H, W, **loss_kw).items():
            tol, stops = early_exit_tolerance(values)
            cases.append((f"{name} {tol:.6g} from zero", zero, early._replace(**{name: tol}), stops))
        for name, case_args, case_opts, stops in cases:
            k = fb.fused_tr_level_batch(*case_args, case_opts, H=H, W=W, **loss_kw)
            p = fb.fused_tr_level_batch_reference(*case_args, case_opts, H=H, W=W, **loss_kw)
            torch.cuda.synchronize()
            what = (
                f"trust-region kernel vs plain{'' if cfg.robust_loss == 'none' else ' ' + cfg.robust_loss}: "
                f"level {level} {H}x{W} {B} pairs{shared_note(i0, t_all)}, "
                f"{name}, iterations {k.iterations.tolist()} [{card}]"
            )
            settled = None if stops is None else stops < EARLY_EXIT_ITERATIONS
            explain = functools.partial(explain_valid_diff, fb, geom, args[3], H, W, what=what) if explain_edge else None
            err, _ = compare_tr_results(k, p, what, strict=name != "preset", settled=settled,
                                        explain_valid=explain)
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


def phase_variants(fb, I9, D9, card):
    """Phase 3b: each kernel's loss and Jacobian variants against its plain
    version on 8 VGA pairs. Returns {kernel: (largest state or Gram
    difference, the variants held)}."""
    from phovo_tpu_torch.models.analytic import prep_frame_analytic
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.utils.config import config_from_dict

    cfg_an = config_from_dict(ANALYTIC_PRESET)
    # every level active: the 480x640 and 240x320 runs and the Gram checks
    cfg_all = config_from_dict(dict(ANALYTIC_PRESET, max_iterations=[3] * 5))
    gn_err = lin_err = 0.0
    worst_cost_vga = {}
    worst_cost_3 = {"nearest": {}, "bilinear": {}}
    for variant in GN_VARIANTS:
        cfg = variant_config(cfg_an, variant)
        packs = pair_packs(prep_frame_analytic(I9, D9, TUM_FR1, cfg))
        for sampling in ("nearest", "bilinear"):
            iterations = {
                level: n if sampling == "bilinear" else min(n, NEAREST_ITERATIONS)
                for level, n in enumerate(cfg.max_iterations)
            }
            gn_err = max(gn_err, compare_levels(fb, packs, TUM_FR1, iterations, sampling, card, cfg)[0])
        del packs
        cfg = variant_config(cfg_all, variant)
        packs = pair_packs(prep_frame_analytic(I9, D9, TUM_FR1, cfg))
        fine = {level: packs[level] for level in (0, 1)}
        for sampling in ("nearest", "bilinear"):
            # 3 iterations: bilinear costs within COST_RTOL, nearest ones
            # split into the order of the sums and sample flips
            bilinear = sampling == "bilinear"
            err, cost = compare_levels(fb, fine, TUM_FR1, {0: 3, 1: 3}, sampling, card, cfg,
                                       check_cost=bilinear, attribute=not bilinear)
            gn_err = max(gn_err, err)
            worst_cost_3[sampling][variant] = cost
            # one iteration: both versions' cost is the weighted sum at the
            # same state, so it differs by the order of the sums alone
            # (later, nearest samples flip with ulp-level state changes)
            cost = compare_levels(fb, fine, TUM_FR1, {0: 1, 1: 1}, sampling, card, cfg, check_cost=True)[1]
            worst_cost_vga[variant] = max(worst_cost_vga.get(variant, 0.0), cost)
        for sampling in ("nearest", "bilinear") if variant in ("none", "esm") else ("bilinear",):
            lin_err = max(lin_err, compare_lin(fb, packs, TUM_FR1, cfg, sampling, card))
        del packs, fine
    packs = pair_packs(prep_frame_analytic(I9, D9, TUM_FR1, cfg_all))
    for sampling in ("nearest", "bilinear"):
        lin_err = max(lin_err, compare_lin(fb, packs, TUM_FR1, cfg_all, sampling, card))
    del packs
    print("kernel vs plain weighted-cost rel diff at 480x640 and 240x320, one linearization: "
          + ", ".join(f"{v} {c:.3e}" for v, c in worst_cost_vga.items()) + f" [{card}]")
    for sampling, costs in worst_cost_3.items():
        print(f"kernel vs plain weighted-cost rel diff at 480x640 and 240x320, 3 iterations, {sampling}"
              f"{' (held to the bound)' if sampling == 'bilinear' else ' (attributed above)'}: "
              + ", ".join(f"{v} {c:.3e}" for v, c in costs.items()) + f" [{card}]")

    cfg_tr = config_from_dict(CERES_PRESET)
    tr_packs = pair_packs(prep_frame_analytic(I9, D9, TUM_FR1, cfg_tr))
    tr_err = 0.0
    for loss in ("huber", "cauchy", "tukey"):
        tr_err = max(tr_err, compare_tr_levels(fb, tr_packs, TUM_FR1, variant_config(cfg_tr, loss), card,
                                               explain_edge=True))
    del tr_packs
    return {
        "fused_gn_level_batch": (gn_err, ["none", *GN_VARIANTS]),
        "fused_tr_level_batch": (tr_err, ["none", "huber", "cauchy", "tukey"]),
        "fused_lin": (lin_err, ["none", *GN_VARIANTS]),
    }


def phase_analytic_api(fb, I8, D16, card):
    """Phase 6b: the per-pair analytic object API (one K-PREP launch and
    one GN launch per active level a pair) and the warm-started chain (one
    GN launch per pair per active level), each against its plain version;
    one 480x640 pair of config_only_level_0_analytic. Returns (launches of
    the per-pair run, largest state difference)."""
    from phovo_tpu_torch.models import analytic
    from phovo_tpu_torch.ops import prep as prep_ops
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.utils.config import config_from_dict

    dev = torch.device("cuda", 0)
    cfg_an = config_from_dict(ANALYTIC_PRESET)
    active = sum(1 for n in cfg_an.max_iterations if n > 0)
    n = N_API_PAIRS + 1
    depth_m = [torch.from_numpy(D16[k]).to(dev).to(torch.float32) * float(np.float32(DEPTH_SCALE)) for k in range(n)]
    Iapi, Dapi = torch.from_numpy(I8[:n]).to(dev), torch.stack(depth_m)
    K = [[TUM_FR1.fx, 0, TUM_FR1.cx], [0, TUM_FR1.fy, TUM_FR1.cy], [0, 0, 1]]

    def per_pair(cfg, pairs):
        vo = analytic.PhotoconsistencyOdometryAnalytic(cfg, device=dev)
        vo.set_intrinsic_matrix(K)
        out = []
        for k in pairs:
            vo.set_source_frame(I8[k], depth_m[k])
            vo.set_target_frame(I8[k + 1], depth_m[k + 1])
            vo.set_initial_state_vector(np.zeros(6))
            out.append(vo.optimize())
        torch.cuda.synchronize()
        return type(out[0])(*(torch.stack(x) for x in zip(*out)))

    def plain(fn):
        with mock.patch.object(analytic, "fused_gn_level_batch", fb.fused_gn_level_batch_reference):
            return fn()

    lm = analytic.align_sequence(Iapi, Dapi, TUM_FR1, cfg_an)
    reset_counts(fb)
    prep_ops.PREP_LAUNCHES = prep_ops.PREP_TORCH_CALLS = 0
    kern = per_pair(cfg_an, range(N_API_PAIRS))
    launches, other = fb.LAUNCHES, fb.TR_LAUNCHES + fb.LIN_LAUNCHES
    preps = (prep_ops.PREP_LAUNCHES, prep_ops.PREP_TORCH_CALLS)
    reset_counts(fb)
    ref = plain(lambda: per_pair(cfg_an, range(N_API_PAIRS)))
    check(fb.LAUNCHES == 0, "the plain per-pair run launched the kernel")
    err = float((kern.state - ref.state).abs().max())
    lm_err = float((kern.state - lm.state).abs().max())
    print(f"analytic per-pair API: {N_API_PAIRS} pairs, K-PREP launches and torch-chain calls {preps} (expected "
          f"({N_API_PAIRS}, 0)), GN launches {launches} (expected {active} x "
          f"{N_API_PAIRS}), other launches {other}, iterations {kern.iterations.tolist()}, max|state diff| "
          f"kernel vs plain {err:.3e}, vs level-major {lm_err:.3e} [{card}]")
    check(launches == active * N_API_PAIRS and other == 0, "optimize() did not launch the GN kernel once per level per pair")
    check(preps == (N_API_PAIRS, 0), "optimize() did not launch K-PREP once a pair")
    check(err <= STATE_ATOL and lm_err <= STATE_ATOL, "per-pair analytic state diff")
    check(torch.equal(kern.iterations, ref.iterations) and torch.equal(kern.num_valid, ref.num_valid),
          "per-pair analytic iterations or valid counts differ")
    worst = max(err, lm_err)

    reset_counts(fb)
    warm = analytic.align_sequence(Iapi, Dapi, TUM_FR1, cfg_an, warm_start=True)
    torch.cuda.synchronize()
    warm_launches = fb.LAUNCHES
    warm_plain = plain(lambda: analytic.align_sequence(Iapi, Dapi, TUM_FR1, cfg_an, warm_start=True))
    err = float((warm.state - warm_plain.state).abs().max())
    print(f"analytic warm start: {N_API_PAIRS} pairs, GN launches {warm_launches}, max|state diff| kernel vs "
          f"plain {err:.3e}, max|state - zero-init state| {float((warm.state - lm.state).abs().max()):.3e} [{card}]")
    check(warm_launches == active * N_API_PAIRS, "the analytic warm chain did not launch once per level per pair")
    check(fb.LAUNCHES == warm_launches, "the plain warm run launched the kernel")
    check(err <= STATE_ATOL and torch.equal(warm.iterations, warm_plain.iterations), "analytic warm chain differs from plain")
    worst = max(worst, err)

    # config_only_level_0_analytic: one 480x640 level, up to 5000 iterations
    cfg0 = config_from_dict(LEVEL0_PRESET)
    reset_counts(fb)
    t0 = time.perf_counter()
    one = per_pair(cfg0, [0])
    wall = time.perf_counter() - t0
    its = int(one.iterations[0, 0])
    print(f"config_only_level_0_analytic: one {SHAPE[0]}x{SHAPE[1]} pair, GN launches {fb.LAUNCHES}, iterations {its}, "
          f"{wall:.3f} s, final ||J^T r|| {float(one.gradient_norm[0, 0]):.3f} [{card}]")
    check(fb.LAUNCHES == 1 and bool(torch.isfinite(one.state).all()), "the level-0 preset did not run once through the kernel")
    if its <= NEAREST_ITERATIONS:
        ref0 = plain(lambda: per_pair(cfg0, [0]))
        err = float((one.state - ref0.state).abs().max())
        print(f"config_only_level_0_analytic: kernel vs plain max|state diff| {err:.3e}")
        check(err <= STATE_ATOL and torch.equal(one.iterations, ref0.iterations), "level-0 preset differs from plain")
        worst = max(worst, err)
    else:
        print(f"config_only_level_0_analytic: not compared with the plain version past "
              f"{NEAREST_ITERATIONS} nearest iterations (chaotic; phase 3b holds 480x640 at 3)")
    return launches, worst


def occluded_pair():
    """A VGA pair with tests/test_robust.py's occluder scaled to VGA."""
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.utils.synthetic import make_pair

    H, W = SHAPE
    I0, D0, I1, D1, gt = make_pair(TUM_FR1, SHAPE)
    I1 = I1.copy()
    r0, c0 = round(10 * H / 96), round(20 * W / 128)
    I1[r0:r0 + int(H * 0.22), c0:c0 + int(W * 0.44)] = 0.95
    return I0, D0, I1, D1, gt


def phase_occlusion(fb, card):
    """Phase 6c: the robust losses on an occluded VGA pair through the
    per-pair object API (tests/test_robust.py's schedule: 2 levels,
    bilinear, 10 and 15 iterations)."""
    from phovo_tpu_torch.models import analytic
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.utils.config import PhovoConfig

    dev = torch.device("cuda", 0)
    I0, D0, I1, D1, gt = occluded_pair()

    def error(loss="none", delta=0.1):
        cfg = PhovoConfig(
            num_levels=2, blur_filter_sizes=(0, 0), gradient_scales=(0.0625, 0.0625),
            max_iterations=(10, 15), lambda_steps=(1.0, 1.0), min_gradient_norms=(1e-10, 1e-10),
            sampling="bilinear", robust_loss=loss, robust_delta=delta,
        )
        vo = analytic.PhotoconsistencyOdometryAnalytic(cfg, device=dev)
        vo.set_intrinsic_matrix([[TUM_FR1.fx, 0, TUM_FR1.cx], [0, TUM_FR1.fy, TUM_FR1.cy], [0, 0, 1]])
        vo.set_source_frame((I0 * 255).astype(np.uint8), D0)
        vo.set_target_frame((I1 * 255).astype(np.uint8), D1)
        return float(np.abs(vo.optimize().state.cpu().numpy() - gt).max())

    reset_counts(fb)
    err_plain = error()
    check(fb.LAUNCHES == 2, "the occluded pair did not run through the GN kernel")
    print(f"occluded VGA pair: 'none' max|state - truth| {err_plain:.4f} (must exceed 0.2) [{card}]")
    check(err_plain > 0.2, "the quadratic cost did not fail on the occluded pair")
    for loss, delta, bound, cut in OCCLUSION_CASES:
        err = error(loss, delta)
        print(f"occluded VGA pair: {loss} (delta {delta}) max|state - truth| {err:.4f} "
              f"(bounds {err_plain / cut:.4f} and {bound}) [{card}]")
        check(err < err_plain / cut and err < bound, f"{loss} did not resist the occluder")


def phase_linearizer(fb, I8, D16, card):
    """Phase 6d: one VGA pair through the per-linearization API
    (gauss_newton_level over make_fused_linearizer, one launch of the
    one-linearization kernel per iteration), huber with ESM, against
    align_analytic on the GN kernel. Returns its launches."""
    from phovo_tpu_torch.models import analytic
    from phovo_tpu_torch.ops import fused as fused_ops
    from phovo_tpu_torch.ops import pyramid as pyr
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.solvers.gauss_newton import gauss_newton_level
    from phovo_tpu_torch.utils.config import config_from_dict

    dev = torch.device("cuda", 0)
    cfg = variant_config(variant_config(config_from_dict(ANALYTIC_PRESET), "huber"), "esm")
    I = torch.from_numpy(I8[:2]).to(dev).to(torch.float32) * (1.0 / 255.0)
    D = torch.from_numpy(D16[:2]).to(dev).to(torch.float32) * float(np.float32(DEPTH_SCALE))
    L, scales = cfg.num_levels, cfg.gradient_scales
    i0, d0, i1 = pyr.build_pyramid(I[0], L), pyr.build_pyramid(D[0], L), pyr.build_pyramid(I[1], L)
    gx0, gy0 = pyr.build_gradient_pyramid(i0, scales)
    gx1, gy1 = pyr.build_gradient_pyramid(i1, scales)
    reset_counts(fb)
    state, its, ends = torch.zeros(6, device=dev), [], []
    t0 = time.perf_counter()
    for level in range(L - 1, -1, -1):
        if cfg.max_iterations[level] <= 0:
            continue
        tgt = fused_ops.pack_target(i1[level], gx1[level], gy1[level])
        linearize = fused_ops.make_fused_linearizer(
            i0[level], d0[level], tgt, TUM_FR1.at_level(level), cfg.min_depth, cfg.max_depth, cfg.sampling,
            cfg.robust_loss, cfg.robust_delta, (gx0[level], gy0[level]),
        )
        res = gauss_newton_level(linearize, state, cfg.max_iterations[level], cfg.min_gradient_norms[level],
                                 cfg.lambda_steps[level])
        state = res.state
        its.append(res.iterations)
        ends.append((level, tgt, state))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, other = fb.LIN_LAUNCHES, fb.LAUNCHES + fb.TR_LAUNCHES
    # each level's Gram at the state it ended at, at the rule's split,
    # against the plain version (these launches come after the count)
    for level, tgt, end in ends:
        H, W = i0[level].shape
        intr = TUM_FR1.at_level(level)
        args = (i0[level].reshape(1, -1).contiguous(),
                fused_ops.pack_geometry(d0[level], intr, cfg.min_depth, cfg.max_depth,
                                        (gx0[level], gy0[level]))[None].contiguous(),
                tgt[None].contiguous(), intr, end.reshape(1, 6).contiguous())
        kw = dict(H=H, W=W, sampling=cfg.sampling, **gn_variant_kw(cfg))
        k, p = fb.fused_lin_batch(*args, **kw), fb.fused_lin_batch_reference(*args, **kw)
        torch.cuda.synchronize()
        rel = float(((k - p).abs() / p.abs().amax(dim=(1, 2), keepdim=True)).max())
        same_nv = torch.equal(k[:, 7, 7], p[:, 7, 7])
        print(f"per-linearization API: level {level} {H}x{W}, G = {fb.lin_split(H, W)} blocks: Gram at the end state "
              f"max|diff| / largest entry {rel:.3e}, nvalid equal {same_nv} [{card}]")
        check(rel <= GRAM_RTOL and same_nv, f"per-linearization Gram at level {level}: rel diff {rel}, nvalid {same_nv}")
    ref = analytic.align_analytic(I[0], D[0], I[1], D[1], TUM_FR1, torch.zeros(6, device=dev), cfg)
    err = float((state - ref.state).abs().max())
    print(f"per-linearization API (huber, ESM): one VGA pair, one-linearization launches {launches} "
          f"(iterations {its}), other launches {other}, {1e3 * wall:.3f} ms of wall time (host-paced: each "
          f"iteration waits for its 6x6 solve; the packs built in it), max|state diff| vs align_analytic "
          f"{err:.3e} [{card}]")
    check(launches == sum(its) and launches > 0 and other == 0, "the linearizer path did not launch once per iteration")
    check(err <= STATE_ATOL, f"linearizer path vs align_analytic state diff {err}")
    ref_its = [int(ref.iterations[lv]) for lv in range(L - 1, -1, -1) if cfg.max_iterations[lv] > 0]
    check(ref_its == its, f"iteration counts {its} differ from align_analytic's {ref_its}")
    return launches


# The card's peaks behind each kernel's bound (NVIDIA's H100 SXM data sheet,
# dense, at 700 W): device memory bytes/s and float32 operations/s outside
# the tensor cores. Every kernel here is float32 CUDA-core work.
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
# float32 operations a kernel does per pixel and pass, counted from its
# per-pixel code (compares, selects, index arithmetic and rounding not
# counted): the level kernels' linearization (phovo_linearize.cuh
# accumulate_pixel: warp 25, rotation-derivative rows 34, chain terms 22,
# residual and columns 22, Gram, J^T r, cost and count 57; bilinear
# sampling of three channels 40 more), K-LIN's 6 sums more, K-IC's pass
# (ic_gn_batch.cu: warp 25, residual 2, J0^T r, cost and count 15; one
# bilinear channel 14 more) and K-ICpre's (ic_precompute.cu: geometry and
# chain terms 23, rows 22, Gram 42).
GN_FLOPS = {"nearest": 160, "bilinear": 200}
# K-GN-bi's depth row on top of GN_FLOPS (accumulate_pixel with kBi: the
# residual 3, the six columns 29, their Gram, J^T r and cost 56; bilinear
# sampling of the three depth channels 40 more)
BI_EXTRA_FLOPS = {"nearest": 88, "bilinear": 128}
LIN_EXTRA_FLOPS = 12
IC_FLOPS = {"nearest": 42, "bilinear": 56}
IC_PRE_FLOPS = 87
# K-ICpre against its plain version: the rows are the same expressions in
# the same order (so the same bits, or an ulp apart); the factor comes from
# the Gram's pixel sums taken in another order, relative to its largest
# entry.
IC_J8_ATOL = 1e-6
IC_L_RTOL = 1e-4


def nbytes(*tensors) -> int:
    """Bytes of the tensors among the arguments (None and other values
    count nothing)."""
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """(the least ms the card could take, what sets it): the larger of the
    bytes over the memory rate and the operations over the float32 rate."""
    ms_bytes = 1e3 * n_bytes / H100_BYTES_PER_S
    ms_ops = 1e3 * flops / H100_F32_FLOPS
    return (ms_bytes, "bytes") if ms_bytes >= ms_ops else (ms_ops, "operations")


def reset_ic_counts(IC, ICB) -> None:
    IC.IC_PRE_LAUNCHES = 0
    ICB.IC_LAUNCHES = 0


def ic_pair_args(prep: dict, level: int, intr):
    """K-IC's inputs for the pairs of per-frame IC products (source k,
    target k + 1) at one level, from the identity."""
    from phovo_tpu_torch.ops.pyramid import level_shape

    geom, J8, L, img = prep[level]
    B = geom.shape[0] - 1
    H, W = level_shape(SHAPE, level)
    Ts = torch.eye(4, device=geom.device).repeat(B, 1, 1)
    return (Ts, geom[:-1], J8[:-1], L[:-1], img[1:], intr.at_level(level)), dict(H=H, W=W)


def compare_ic_level(ICB, args, kw, n, threshold, sampling, what, card):
    """K-IC against its plain version on the same inputs, n iterations at
    most with the gradient-norm threshold: poses within STATE_ATOL, equal
    iteration and valid counts, nothing band-masked. Returns the kernel's
    result and the largest pose difference."""
    k = ICB.ic_gn_level_batch(*args, n, threshold, 1.0, sampling=sampling, **kw)
    p = ICB.ic_gn_level_batch_reference(*args, n, threshold, 1.0, sampling=sampling, **kw)
    torch.cuda.synchronize()
    err = float((k.T - p.T).abs().max())
    cost_rel = float(((k.cost - p.cost).abs() / p.cost.abs().clamp_min(1e-30)).max())
    same = torch.equal(k.iterations, p.iterations) and torch.equal(k.num_valid, p.num_valid)
    print(f"IC kernel vs plain: {what} {kw['H']}x{kw['W']} {sampling} {args[0].shape[0]} pairs, budget {n}, "
          f"threshold {threshold:.6g}: max|pose diff| {err:.3e}, iterations {k.iterations.tolist()}, "
          f"iterations and valid counts equal {same}, max cost rel diff {cost_rel:.3e} [{card}]")
    check(err <= STATE_ATOL, f"IC {what}: pose diff {err} > {STATE_ATOL}")
    check(same, f"IC {what}: iterations or valid counts differ")
    check(float(k.band_masked.abs().sum()) == 0.0, f"IC {what}: band_masked not 0")
    return k, err


def compare_ic_pre(IC, args, what, card):
    """K-ICpre against its plain version on the same frames: J8 within
    IC_J8_ATOL, the factor within IC_L_RTOL of its largest entry. Returns
    (J8 difference, factor relative difference)."""
    J8, L = IC.ic_precompute_batch(*args)
    pJ8, pL = IC.ic_precompute_batch_reference(*args)
    torch.cuda.synchronize()
    j8 = float((J8 - pJ8).abs().max())
    l_rel = float(((L - pL).abs() / pL.abs().amax(dim=1, keepdim=True)).max())
    H, W = args[0].shape[1:]
    print(f"IC precompute kernel vs plain: {what} {H}x{W}, {args[0].shape[0]} frames, {ic_layout('icpre', H, W)}: "
          f"max|J8 diff| {j8:.3e} ({int((J8 != pJ8).sum())} of {J8.numel()} entries differ), max|L diff| / max|L| "
          f"{l_rel:.3e} [{card}]")
    check(j8 <= IC_J8_ATOL, f"IC precompute {what}: J8 diff {j8} > {IC_J8_ATOL}")
    check(l_rel <= IC_L_RTOL, f"IC precompute {what}: factor rel diff {l_rel} > {IC_L_RTOL}")
    return j8, l_rel


def phase_ic_kernels(I9, D9, card):
    """Phase 3c: K-ICpre against its plain version on 8 VGA frames at all
    five levels; K-IC against its plain version on 8 VGA pairs at every
    active level of the bench schedule from the identity: bilinear over
    the whole schedule, nearest over NEAREST_ITERATIONS, and per sampling
    an early-exit case whose threshold lies at least EARLY_EXIT_MARGIN
    from every ||g|| the plain version reads before a stop. Returns the
    largest differences: (J8, L relative, pose)."""
    from phovo_tpu_torch.models.ic import prep_frame_ic
    from phovo_tpu_torch.ops import ic as IC
    from phovo_tpu_torch.ops import ic_batch as ICB
    from phovo_tpu_torch.ops import pyramid as pyr
    from phovo_tpu_torch.ops.camera import TUM_FR1

    cfg = bench_config(0.0)
    ints = pyr.build_pyramid(I9[:8], cfg.num_levels, cfg.blur_filter_sizes, blur_type=cfg.blur_type)
    deps = pyr.build_pyramid(D9[:8], cfg.num_levels)
    j8_err = l_err = 0.0
    for level in range(cfg.num_levels):
        img, dep = ints[level].contiguous(), deps[level].contiguous()
        scale = cfg.gradient_scales[level]
        args = (img, dep, pyr.scharr(img, "x", scale), pyr.scharr(img, "y", scale), TUM_FR1.at_level(level),
                cfg.min_depth, cfg.max_depth)
        j8, l_rel = compare_ic_pre(IC, args, f"level {level}", card)
        j8_err, l_err = max(j8_err, j8), max(l_err, l_rel)
    del ints, deps

    prep = prep_frame_ic(I9, D9, TUM_FR1, cfg)
    pose_err = 0.0
    for sampling in ("nearest", "bilinear"):
        for level in sorted(prep, reverse=True):
            args, kw = ic_pair_args(prep, level, TUM_FR1)
            n = cfg.max_iterations[level]
            n = n if sampling == "bilinear" else min(n, NEAREST_ITERATIONS)
            pose_err = max(pose_err, compare_ic_level(ICB, args, kw, n, 0.0, sampling, f"level {level}", card)[1])
    for sampling in ("nearest", "bilinear"):
        budget = EARLY_EXIT_ITERATIONS if sampling == "bilinear" else NEAREST_ITERATIONS
        for level in sorted(prep, reverse=True):
            args, kw = ic_pair_args(prep, level, TUM_FR1)
            B = args[0].shape[0]
            values = [torch.full((B,), float("inf"), dtype=torch.float64)]
            values += [
                ICB.ic_gn_level_batch_reference(*args, m, 0.0, 1.0, sampling=sampling, **kw).gradient_norm.double().cpu()
                for m in range(1, budget + 1)
            ]
            tol, stops = early_exit_tolerance(torch.stack(values))
            k, err = compare_ic_level(ICB, args, kw, budget, tol, sampling, f"early exit, level {level}", card)
            check(k.iterations.cpu().tolist() == stops.tolist(),
                  f"IC early exit level {level} {sampling}: stopped after {k.iterations.tolist()}, predicted {stops.tolist()}")
            pose_err = max(pose_err, err)
    return j8_err, l_err, pose_err


# Cluster sizes of K-IC's and K-ICpre's layout checks (above 8 only where
# the card schedules it)
IC_SWEEP = (1, 2, 4, 8, 16)


def phase_ic_layouts(I9, D9, card):
    """Phase 3c, the cluster layout of K-IC and K-ICpre: (a) K-IC against
    its plain version on one pair at 480x640 and 240x320 (streamed, in
    clusters), bilinear and nearest over NEAREST_ITERATIONS, and K-ICpre
    on one 480x640 frame; (b) on 8 pairs at every VGA level through the C
    entries, every size of IC_SWEEP against one block a pair (poses within
    STATE_ATOL, iteration and valid counts equal; K-ICpre's J8 the same
    bits, its factor within IC_L_RTOL) and a resident pack against a
    streamed one at the same size (the same bits); (c) at 480x640, 120x160
    and 60x80, pairs and frames alone against the same ones inside a
    256-pair (257-frame) launch, bit for bit. Returns the largest
    differences: (J8, L relative, pose)."""
    from phovo_tpu_torch.ops import _build
    from phovo_tpu_torch.ops import ic as IC
    from phovo_tpu_torch.ops import ic_batch as ICB
    from phovo_tpu_torch.ops.camera import TUM_FR1

    j8_err = l_err = pose_err = 0.0
    prep, pre = ic_timing_prep(I9, D9)
    for level in (0, 1):
        args, kw = ic_pair_args({level: tuple(x[:2] for x in prep[level])}, level, TUM_FR1)
        for sampling in ("bilinear", "nearest"):
            what = f"B = 1, {ic_layout('ic', kw['H'], kw['W'])}, level {level}"
            pose_err = max(pose_err, compare_ic_level(ICB, args, kw, NEAREST_ITERATIONS, 0.0, sampling, what, card)[1])
    j8, l_rel = compare_ic_pre(IC, tuple(x[:1] for x in pre[0][:4]) + pre[0][4:], "B = 1", card)
    j8_err, l_err = max(j8_err, j8), max(l_err, l_rel)

    lib = _build.library()
    for group, label, kind, args, kw in ic_workloads(prep, pre, (8,)):
        fn, names = getattr(lib, LEVEL_ENTRIES[kind][1]), entry_names(kind)
        H, W = (kw["H"], kw["W"]) if kind == "ic" else args[0].shape[1:]
        if kind == "ic":
            kw = dict(kw, sampling="bilinear")
        base = entry_launcher(fn, names, kind, args, kw, 1, **({"resident": False} if kind == "ic" else {}))
        base[0]()
        seen = []
        for c in IC_SWEEP:
            forms = [False, True] if kind == "ic" and ICB.ic_pack_fits(H, W, c) else [False]
            outs = {}
            for resident in forms:
                run = entry_launcher(fn, names, kind, args, kw, c, **({"resident": resident} if kind == "ic" else {}))
                try:
                    run[0]()
                except RuntimeError as err:
                    check(c > 8 and "CUDA error 912" in str(err), f"{group} {label}: C = {c} failed: {err}")
                    print(f"IC layouts, {group}, {label}: C = {c} refused by the card ({err})")
                    break
                torch.cuda.synchronize()
                outs[resident] = run[1:]
            if not outs:
                continue
            out, diag = outs[False]
            if True in outs:
                check(all(torch.equal(a, b) for a, b in zip(outs[True], outs[False])),
                      f"{group} {label}: C = {c} resident differs from streamed")
            if kind == "ic":
                err = float((out - base[1]).abs().max())
                same = torch.equal(diag[:, 0], base[2][:, 0]) and torch.equal(diag[:, 3], base[2][:, 3])
                check(err <= STATE_ATOL and same, f"{group} {label}: C = {c} against C = 1: pose {err}, counts {same}")
                pose_err = max(pose_err, err)
                seen.append(f"C = {c}{' (resident = streamed bits)' if True in outs else ''} {err:.1e}")
            else:
                l_rel = float(((out - base[1]).abs() / base[1].abs().amax(dim=1, keepdim=True)).max())
                check(torch.equal(diag, base[2]) and l_rel <= IC_L_RTOL,
                      f"{group} {label}: C = {c} against C = 1: J8 bits {torch.equal(diag, base[2])}, L {l_rel}")
                l_err = max(l_err, l_rel)
                seen.append(f"C = {c} {l_rel:.1e}")
        print(f"IC layouts, {group}, {label}, rule {ic_layout(kind, H, W)}: against C = 1 "
              f"({'pose' if kind == 'ic' else 'J8 the same bits, L relative'}): {'; '.join(seen)} [{card}]")
    del prep, pre

    # (c) 257 frames cycled from the 9; pairs and frames alone at three levels
    idx = torch.arange(N_FRAMES, device=I9.device) % I9.shape[0]
    prep, pre = ic_timing_prep(I9[idx].contiguous(), D9[idx].contiguous())
    for level in (0, 2, 3):
        args, kw = ic_pair_args(prep, level, TUM_FR1)
        full = ICB.ic_gn_level_batch(*args, IC_ITERATIONS[level], 0.0, 1.0, sampling="bilinear", **kw)
        J8, L = IC.ic_precompute_batch(*pre[level])
        bits = True
        for j in (0, 1, 128, 255):
            one = ICB.ic_gn_level_batch(*(x[j:j + 1] for x in args[:5]), args[5], IC_ITERATIONS[level], 0.0, 1.0,
                                        sampling="bilinear", **kw)
            bits &= all(torch.equal(a, b[j:j + 1]) for a, b in zip(one, full))
            oJ8, oL = IC.ic_precompute_batch(*(x[j:j + 1] for x in pre[level][:4]), *pre[level][4:])
            bits &= torch.equal(oJ8, J8[j:j + 1]) and torch.equal(oL, L[j:j + 1])
        torch.cuda.synchronize()
        print(f"IC layouts, level {level} {kw['H']}x{kw['W']}: pairs 0, 1, 128, 255 alone against their {args[0].shape[0]}-pair "
              f"K-IC launch ({ic_layout('ic', kw['H'], kw['W'])}) and frames alone against their {N_FRAMES}-frame K-ICpre "
              f"launch ({ic_layout('icpre', kw['H'], kw['W'])}): the same bits {bits} [{card}]")
        check(bits, f"IC level {level}: a pair or frame alone differs from its batch")
        del full, J8, L
    return j8_err, l_err, pose_err


def phase_ic_main(run_chain, fb, se3, traj, gts, ts, card):
    """Phase 4b: the IC main path, the 257 frames through
    align_sequence_chunk_ic in the two chunks with the bench schedule, early
    exit at 300 and fixed-75, each with the launch counts set to 0 just
    before and read just after; then once more through the plain versions.
    Early exit: per-pair agreement on the pairs whose every level ran at
    most NEAREST_ITERATIONS iterations (further nearest iterations are
    chaotic); fixed-75: the difference is printed, not held. Both: finite
    states and the ATE below standing still. Returns the early-exit run's
    launches (K-ICpre, K-IC) and its largest compared pose difference."""
    from phovo_tpu_torch.models import ic
    from phovo_tpu_torch.ops import ic as IC
    from phovo_tpu_torch.ops import ic_batch as ICB

    out = None
    for name, cfg in (("early exit at 300", bench_config(300.0)), ("fixed-75", bench_config(0.0))):
        active = sum(1 for n in cfg.max_iterations if n > 0)
        reset_counts(fb)
        kern = run_chain(ic.align_sequence_chunk_ic, cfg)
        launches = (IC.IC_PRE_LAUNCHES, ICB.IC_LAUNCHES)
        other = fb.LAUNCHES + fb.TR_LAUNCHES + fb.LIN_LAUNCHES
        print(f"IC path, {name}: K-ICpre launches {launches[0]}, K-IC launches {launches[1]} (expected {active} "
              f"levels x {len(CHUNKS)} chunks each), other kernels {other}")
        check(launches == (active * len(CHUNKS),) * 2 and other == 0,
              "the IC path did not launch K-ICpre and K-IC once per active level of every chunk")
        with mock.patch.object(IC, "ic_precompute_batch", IC.ic_precompute_batch_reference), \
                mock.patch.object(ic, "ic_gn_level_batch", ICB.ic_gn_level_batch_reference):
            plain = run_chain(ic.align_sequence_chunk_ic, cfg)
        check((IC.IC_PRE_LAUNCHES, ICB.IC_LAUNCHES) == launches, "the plain IC run launched a kernel")
        diff = (kern.state - plain.state).abs().amax(dim=1)
        its = kern.iterations.cpu()
        short = (kern.iterations <= NEAREST_ITERATIONS).all(dim=1)
        err = float(diff[short].max()) if bool(short.any()) else float("nan")
        same = torch.equal(kern.iterations[short], plain.iterations[short]) and torch.equal(
            kern.num_valid[short], plain.num_valid[short])
        print(f"IC path, {name}: {kern.state.shape[0]} pairs, iterations per level (mean) "
              f"{its.double().mean(dim=0).numpy().round(3).tolist()} (max {its.max(dim=0).values.tolist()}); "
              f"kernel vs plain on the {int(short.sum())} pairs of at most {NEAREST_ITERATIONS} iterations a level: "
              f"max|state diff| {err:.3e}, iterations and valid counts equal {same}; over all pairs "
              f"{float(diff.max()):.3e} [{card}]")
        if name.startswith("early"):
            check(bool(short.any()) and err <= STATE_ATOL and same, "IC early-exit chain differs from plain")
            out = (launches, err)
        check(bool(torch.isfinite(kern.state).all()), "non-finite IC states")
        check(tuple(kern.state.shape) == (N_FRAMES - 1, 6), f"IC state shape {tuple(kern.state.shape)}")
        ate, still = trajectory_ate(se3, traj, kern.state, gts, ts)
        print(f"IC path, {name}: ATE rmse {ate:.6f} m (identity trajectory {still:.6f} m)")
        check(np.isfinite(ate) and ate < still, "IC ATE not finite or not below standing still")
    return out


def phase_ic_api(I8, D16, card):
    """Phase 6e: N_API_PAIRS pairs through PhotoconsistencyOdometryIC on the
    card (one K-ICpre and one K-IC launch per active level a pair) against
    the level-major chain on the same frames; one 480x640 pair of
    config_only_level_0_analytic. Returns (K-IC launches of the per-pair
    run, largest state difference)."""
    from phovo_tpu_torch.models import ic
    from phovo_tpu_torch.ops.prep import device_unit_intensity
    from phovo_tpu_torch.ops import ic as IC
    from phovo_tpu_torch.ops import ic_batch as ICB
    from phovo_tpu_torch.ops import pyramid as pyr
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.utils.config import config_from_dict

    dev = torch.device("cuda", 0)
    cfg = bench_config(300.0)
    active = sum(1 for n in cfg.max_iterations if n > 0)
    n = N_API_PAIRS + 1
    depth_m = [torch.from_numpy(D16[k]).to(dev).to(torch.float32) * float(np.float32(DEPTH_SCALE)) for k in range(n)]
    Iapi, Dapi = torch.from_numpy(I8[:n]).to(dev), torch.stack(depth_m)
    K = [[TUM_FR1.fx, 0, TUM_FR1.cx], [0, TUM_FR1.fy, TUM_FR1.cy], [0, 0, 1]]

    def per_pair(cfg, pairs):
        vo = ic.PhotoconsistencyOdometryIC(cfg)
        check(vo.device.type == "cuda", f"the IC object API defaults to {vo.device}, not the card")
        vo.set_intrinsic_matrix(K)
        res = []
        for k in pairs:
            vo.set_source_frame(I8[k], depth_m[k])
            vo.set_target_frame(I8[k + 1], depth_m[k + 1])
            vo.set_initial_state_vector(np.zeros(6))
            res.append(vo.optimize())
        torch.cuda.synchronize()
        return type(res[0])(*(torch.stack(x) for x in zip(*res)))

    lm = ic.align_sequence_ic(Iapi, Dapi, TUM_FR1, cfg)
    reset_ic_counts(IC, ICB)
    kern = per_pair(cfg, range(N_API_PAIRS))
    launches = (IC.IC_PRE_LAUNCHES, ICB.IC_LAUNCHES)
    bits = all(torch.equal(a, b) for a, b in zip(kern, lm))
    err = float((kern.state - lm.state).abs().max())
    # where a difference can come from: K-ICpre and K-IC give the same bits
    # for the same inputs whatever B is, so from the pyramids, built per
    # pair here and for all frames at once there
    Ifl = device_unit_intensity(Iapi).to(torch.float32)
    pyr_one = pyr.build_pyramid(Ifl[0], cfg.num_levels)
    pyr_all = pyr.build_pyramid(Ifl, cfg.num_levels)
    pyr_diff = max(float((pyr_one[lv] - pyr_all[lv][0]).abs().max())
                   for lv in range(cfg.num_levels) if cfg.max_iterations[lv] > 0)
    print(f"IC per-pair API: {N_API_PAIRS} pairs, K-ICpre launches {launches[0]}, K-IC launches {launches[1]} "
          f"(expected {active} x {N_API_PAIRS} each), iterations {kern.iterations.tolist()}; against the level-major "
          f"chain: the same bits {bits}, max|state diff| {err:.3e}; source pyramid, one frame vs all frames at once: "
          f"max|diff| {pyr_diff:.3e} [{card}]")
    check(launches == (active * N_API_PAIRS,) * 2, "optimize() did not launch the IC kernels once per level per pair")
    check(err <= STATE_ATOL and torch.equal(kern.iterations, lm.iterations), "IC per-pair route differs from the level-major chain")

    cfg0 = config_from_dict(LEVEL0_PRESET)
    reset_ic_counts(IC, ICB)
    t0 = time.perf_counter()
    one = per_pair(cfg0, [0])
    wall = time.perf_counter() - t0
    its = int(one.iterations[0, 0])
    print(f"IC config_only_level_0_analytic: one {SHAPE[0]}x{SHAPE[1]} pair, K-ICpre launches {IC.IC_PRE_LAUNCHES}, "
          f"K-IC launches {ICB.IC_LAUNCHES}, iterations {its}, {wall:.3f} s, final ||J0^T r|| "
          f"{float(one.gradient_norm[0, 0]):.3f} [{card}]")
    check((IC.IC_PRE_LAUNCHES, ICB.IC_LAUNCHES) == (1, 1) and bool(torch.isfinite(one.state).all()),
          "the level-0 preset did not run once through the IC kernels")
    return launches[1], err


# K-IC's nearest iterations per VGA level in the timing workloads and the
# sweep: the bench schedule's at levels 2-4, NEAREST_ITERATIONS at the
# levels it skips
IC_ITERATIONS = (NEAREST_ITERATIONS, NEAREST_ITERATIONS, 5, 20, 50)


def ic_timing_prep(Is, Ds):
    """The IC products of the timing frames at all five levels: ({level:
    (geom, J8, L, target image)} from prep_frame_ic, {level: K-ICpre's
    inputs (img, depth, gx, gy, intrinsics, min_depth, max_depth)})."""
    from phovo_tpu_torch.models.ic import prep_frame_ic
    from phovo_tpu_torch.ops import pyramid as pyr
    from phovo_tpu_torch.ops.camera import TUM_FR1

    cfg = dataclasses.replace(bench_config(0.0), max_iterations=IC_ITERATIONS)
    prep = prep_frame_ic(Is, Ds, TUM_FR1, cfg)
    ints = pyr.build_pyramid(Is, cfg.num_levels)
    deps = pyr.build_pyramid(Ds, cfg.num_levels)
    pre = {}
    for level in range(cfg.num_levels):
        img, dep = ints[level].contiguous(), deps[level].contiguous()
        scale = cfg.gradient_scales[level]
        pre[level] = (img, dep, pyr.scharr(img, "x", scale), pyr.scharr(img, "y", scale), TUM_FR1.at_level(level),
                      cfg.min_depth, cfg.max_depth)
    return prep, pre


def ic_workloads(prep, pre, batches, levels=range(5)):
    """[(group, label, kind, wrapper args, wrapper kw)] of K-ICpre and K-IC
    per level on ic_timing_prep's products: K-ICpre on the first B frames
    (all 257 for B = 256, the chain's launch), K-IC on the first B pairs
    from the identity, IC_ITERATIONS[level] nearest iterations, threshold
    0 (the same work every run)."""
    from phovo_tpu_torch.ops.camera import TUM_FR1

    cases = []
    for B in batches:
        frames = B + 1 if B == N_FRAMES - 1 else B
        for level in levels:
            img, dep, gx, gy, *rest = pre[level]
            H, W = img.shape[1:]
            label = f"level {level} {H}x{W}"
            cases.append((f"K-ICpre B = {frames}", label, "icpre", (img[:frames], dep[:frames], gx[:frames],
                                                                    gy[:frames], *rest), {}))
            args, kw = ic_pair_args({level: tuple(x[:B + 1] for x in prep[level])}, level, TUM_FR1)
            cases.append((f"K-IC B = {B}", label, "ic", (*args, IC_ITERATIONS[level], 0.0, 1.0),
                          dict(kw, sampling="nearest")))
    return cases


def ic_layout(kind, H, W) -> str:
    """The rule's layout of a level: 'C = 8, resident' for K-IC, 'C = 8'
    for K-ICpre."""
    from phovo_tpu_torch.ops import ic as IC
    from phovo_tpu_torch.ops import ic_batch as ICB

    if kind == "icpre":
        return f"C = {IC.ic_precompute_cluster_size(H, W)}"
    c = ICB.ic_cluster_size(H, W)
    return f"C = {c}, " + ("resident" if ICB.ic_resident(H, W, c) else "streamed")


def ic_case_work(kind, args, kw, out, diag) -> tuple[int, float]:
    """(bytes, float32 operations) of one ic_workloads launch for bound:
    its inputs read once, its outputs written once, K-IC's pixel work for
    the iterations each pair ran."""
    if kind == "icpre":
        return nbytes(*args[:4], out, diag), args[0].numel() * IC_PRE_FLOPS
    Ts, geom, J8, L, t_i = args[:5]
    flops = float(diag[:, 0].double().sum()) * kw["H"] * kw["W"] * IC_FLOPS[kw["sampling"]]
    return nbytes(Ts, geom[:, :3], J8, L, t_i, out, diag), flops


def phase_ic_timing(Is, Ds, card):
    """Phase 7c: the IC chain per 256 pairs (fixed-75 and early exit at 300)
    beside the analytic chain at the same config, in turns (analytic, IC,
    IC, analytic); the IC prep layer; K-ICpre and K-IC per level at 256
    pairs (the bench chain's levels) and at B = 1 (all five levels) through
    their C entries at the rule's layout, against their plain versions
    (plain, kernel, kernel, plain), each with its bound, C and residency;
    align_ic a VGA pair. Returns the kernels' record fields."""
    from phovo_tpu_torch.models import ic
    from phovo_tpu_torch.models.analytic import align_sequence
    from phovo_tpu_torch.models.ic import prep_frame_ic
    from phovo_tpu_torch.ops import _build
    from phovo_tpu_torch.ops import ic as IC
    from phovo_tpu_torch.ops import ic_batch as ICB
    from phovo_tpu_torch.ops.camera import TUM_FR1

    dev = Is.device
    n_pairs = Is.shape[0] - 1
    cfg_fixed, cfg_ee = bench_config(0.0), bench_config(300.0)
    for name, cfg in (("fixed-75", cfg_fixed), ("early exit at 300", cfg_ee)):
        a1 = cuda_ms(lambda: align_sequence(Is, Ds, TUM_FR1, cfg), REPEATS)
        i1 = cuda_ms(lambda: ic.align_sequence_ic(Is, Ds, TUM_FR1, cfg), REPEATS)
        i2 = cuda_ms(lambda: ic.align_sequence_ic(Is, Ds, TUM_FR1, cfg), REPEATS)
        a2 = cuda_ms(lambda: align_sequence(Is, Ds, TUM_FR1, cfg), REPEATS)
        print(f"IC chain {name}: {1e3 * n_pairs / ((i1 + i2) / 2):.1f} pairs/s ({i1:.3f}, {i2:.3f} ms / {n_pairs} "
              f"pairs); analytic chain beside it {a1:.3f}, {a2:.3f} ms [{card}]")
    ms_prep = cuda_ms(lambda: prep_frame_ic(Is, Ds, TUM_FR1, cfg_fixed), REPEATS)
    print(f"layer IC prep (pyramids, source Scharr, K-ICpre, geometry of {Is.shape[0]} frames): {ms_prep:.3f} ms [{card}]")

    lib = _build.library()
    names = {"ic": "ic_gn_level_batch", "icpre": "ic_precompute"}
    plains = {"ic": ICB.ic_gn_level_batch_reference, "icpre": IC.ic_precompute_batch_reference}
    rec = {name: dict(ms=0.0, plain_ms=0.0, bytes=0, flops=0) for name in names.values()}
    prep, pre = ic_timing_prep(Is, Ds)
    bench_levels = [lv for lv, n in enumerate(cfg_fixed.max_iterations) if n > 0]
    cases = ic_workloads(prep, pre, (n_pairs,), bench_levels) + ic_workloads(prep, pre, (1,))
    for group, label, kind, args, kw in cases:
        H, W = (kw["H"], kw["W"]) if kind == "ic" else args[0].shape[1:]
        run, out, diag = entry_launcher(getattr(lib, LEVEL_ENTRIES[kind][1]), entry_names(kind), kind, args, kw)
        n_plain = 2 if args[0].shape[0] > 1 else 3
        p1 = cuda_ms(lambda: plains[kind](*args, **kw), n_plain)
        k1 = cuda_ms(run, REPEATS)
        k2 = cuda_ms(run, REPEATS)
        p2 = cuda_ms(lambda: plains[kind](*args, **kw), n_plain)
        k, p = (k1 + k2) / 2, (p1 + p2) / 2
        work = ic_case_work(kind, args, kw, out, diag)
        b = bound(*work)
        its = f", {int(diag[:, 0].max())} it" if kind == "ic" else ""
        print(f"layer {group}, {label}{its}, {ic_layout(kind, H, W)}: kernel {k:.4f} ms ({k1:.4f}, {k2:.4f}), plain "
              f"{p:.3f} ms ({p1:.3f}, {p2:.3f}), bound {b[0]:.5f} ms ({b[1]}), kernel / bound {k / b[0]:.2f} [{card}]")
        if args[0].shape[0] > 1:
            r = rec[names[kind]]
            r["ms"] += k
            r["plain_ms"] += p
            r["bytes"] += work[0]
            r["flops"] += work[1]
    del prep, pre
    zero6 = torch.zeros(6, device=dev)
    ms_pair = cuda_ms(lambda: ic.align_ic(Is[0], Ds[0], Is[1], Ds[1], TUM_FR1, zero6, cfg_ee), REPEATS)
    print(f"per-pair IC route: align_ic {ms_pair:.3f} ms a VGA pair (bench schedule, early exit at 300, "
          f"3 launches of each kernel at B = 1) [{card}]")
    for name, r in rec.items():
        r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), r.pop("flops"))
        print(f"{name}: bench chain {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]")
    return rec


# The losses the bi-objective level takes (no Student-t, no ESM)
BI_LOSSES = ("none", "huber", "cauchy", "tukey")


def bi_early_exit(fb, packs, intr, cfg, sampling, card):
    """K-GN-bi early-exit cases from zero, one per level of packs: a
    gradient-norm threshold at least EARLY_EXIT_MARGIN from every ||g||
    the plain version reads before a stop (early_exit_tolerance), over
    EARLY_EXIT_ITERATIONS bilinear or NEAREST_ITERATIONS nearest; kernel
    and plain must stop after the predicted counts with states within
    STATE_ATOL; valid counts may differ only where explain_gn_valid_diff
    accounts for them by edge pixels or flipped samples. Returns the
    largest state difference."""
    from phovo_tpu_torch.ops.pyramid import level_shape

    budget = EARLY_EXIT_ITERATIONS if sampling == "bilinear" else NEAREST_ITERATIONS
    worst = 0.0
    for level, (i0, geom, t6, gains) in sorted(packs.items(), reverse=True):
        H, W = level_shape(SHAPE, level)
        args = (i0, geom, t6, intr.at_level(level), torch.zeros((i0.shape[0], 6), device=i0.device))
        kw = dict(H=H, W=W, sampling=sampling, depth_gains=gains, **gn_variant_kw(cfg))
        values = [torch.full((i0.shape[0],), float("inf"), dtype=torch.float64)]
        values += [fb.fused_gn_level_batch_reference(*args, m, 0.0, 1.0, **kw).gradient_norm.double().cpu()
                   for m in range(1, budget + 1)]
        tol, stops = early_exit_tolerance(torch.stack(values))
        k = fb.fused_gn_level_batch(*args, budget, tol, 1.0, **kw)
        p = fb.fused_gn_level_batch_reference(*args, budget, tol, 1.0, **kw)
        torch.cuda.synchronize()
        err = float((k.state - p.state).abs().max())
        what = (f"bi-objective kernel vs plain {cfg.robust_loss}, early exit: level {level} {H}x{W} {sampling} "
                f"{i0.shape[0]} pairs, budget {budget}, threshold {tol:.6g}")
        print(f"{what}: iterations {k.iterations.tolist()} (predicted {stops.tolist()}), max|state diff| "
              f"{err:.3e} [{card}]")
        check(k.iterations.cpu().tolist() == stops.tolist() and p.iterations.cpu().tolist() == stops.tolist(),
              f"bi-objective early exit level {level} {sampling}: did not stop where predicted")
        check(err <= STATE_ATOL, "bi-objective early exit differs from plain")
        if not torch.equal(k.num_valid, p.num_valid):
            explain_gn_valid_diff(fb, args + (budget, tol, 1.0), kw, k, p, what)
        worst = max(worst, err)
    return worst


def phase_bi_kernels(fb, I9, D9, card):
    """Phase 3d: K-GN-bi against its plain version on 8 VGA pairs at all
    five levels, with each loss of BI_LOSSES at its LOSS_DELTAS scale:
    bilinear over the bench schedule's iterations (3 at the two finest
    levels), states within STATE_ATOL and equal counts (valid counts that
    explain_valid_diff accounts for by edge pixels); nearest over
    NEAREST_ITERATIONS, the cost split by attribute_nearest_cost; and an
    early-exit case from zero per level and sampling. Returns the largest
    state difference."""
    from phovo_tpu_torch.models.biobjective import prep_frame_biobjective
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.utils.config import config_from_dict

    cfg_all = config_from_dict(dict(ANALYTIC_PRESET, max_iterations=[3, 3, 5, 20, 50]))
    worst = 0.0
    for loss in BI_LOSSES:
        cfg = variant_config(cfg_all, loss)
        packs = pair_packs(prep_frame_biobjective(I9, D9, TUM_FR1, cfg))
        whole = dict(enumerate(cfg.max_iterations))
        worst = max(worst, compare_levels(fb, packs, TUM_FR1, whole, "bilinear", card, cfg, explain_edge=True)[0])
        short = {level: min(n, NEAREST_ITERATIONS) for level, n in whole.items()}
        worst = max(worst, compare_levels(fb, packs, TUM_FR1, short, "nearest", card, cfg, attribute=True)[0])
        for sampling in ("nearest", "bilinear"):
            worst = max(worst, bi_early_exit(fb, packs, TUM_FR1, cfg, sampling, card))
        del packs
    return worst


def phase_bi_main(run_chain, fb, se3, traj, gts, ts, analytic_ate, card):
    """Phase 4c: the bi-objective main path, the 257 frames through
    align_sequence_chunk_biobjective in the two chunks with the bench
    schedule, early exit at 300 and fixed-75, each with the launch counts
    set to 0 just before and read just after; then once more through the
    plain version. Early exit: per-pair agreement on the pairs whose every
    level ran at most NEAREST_ITERATIONS iterations (further nearest
    iterations are chaotic); fixed-75: the difference is printed, not
    held. Both: finite states and the ATE below standing still, the
    analytic chain's beside it. Returns the early-exit run's launches and
    its largest compared state difference."""
    from phovo_tpu_torch.models import analytic, biobjective

    out = None
    for name, cfg in (("early exit at 300", bench_config(300.0)), ("fixed-75", bench_config(0.0))):
        active = sum(1 for n in cfg.max_iterations if n > 0)
        reset_counts(fb)
        kern = run_chain(biobjective.align_sequence_chunk_biobjective, cfg)
        launches, other = fb.LAUNCHES, fb.TR_LAUNCHES + fb.LIN_LAUNCHES
        print(f"bi-objective path, {name}: K-GN-bi launches {launches} (expected {active} levels x "
              f"{len(CHUNKS)} chunks), other kernels {other}")
        check(launches == active * len(CHUNKS) and other == 0,
              "the bi-objective path did not launch K-GN-bi once per active level of every chunk")
        reset_counts(fb)
        with mock.patch.object(analytic, "fused_gn_level_batch", fb.fused_gn_level_batch_reference):
            plain = run_chain(biobjective.align_sequence_chunk_biobjective, cfg)
        check(fb.LAUNCHES == 0, "the plain bi-objective run launched the kernel")
        diff = (kern.state - plain.state).abs().amax(dim=1)
        its = kern.iterations.cpu()
        short = (kern.iterations <= NEAREST_ITERATIONS).all(dim=1)
        err = float(diff[short].max()) if bool(short.any()) else float("nan")
        same = torch.equal(kern.iterations[short], plain.iterations[short]) and torch.equal(
            kern.num_valid[short], plain.num_valid[short])
        print(f"bi-objective path, {name}: {kern.state.shape[0]} pairs, iterations per level (mean) "
              f"{its.double().mean(dim=0).numpy().round(3).tolist()} (max {its.max(dim=0).values.tolist()}); "
              f"kernel vs plain on the {int(short.sum())} pairs of at most {NEAREST_ITERATIONS} iterations a "
              f"level: max|state diff| {err:.3e}, iterations and valid counts equal {same}; over all pairs "
              f"{float(diff.max()):.3e} [{card}]")
        if name.startswith("early"):
            check(bool(short.any()) and err <= STATE_ATOL and same, "bi-objective early-exit chain differs from plain")
            out = (launches, err)
        check(bool(torch.isfinite(kern.state).all()), "non-finite bi-objective states")
        check(tuple(kern.state.shape) == (N_FRAMES - 1, 6), f"bi-objective state shape {tuple(kern.state.shape)}")
        ate, still = trajectory_ate(se3, traj, kern.state, gts, ts)
        print(f"bi-objective path, {name}: ATE rmse {ate:.6f} m (analytic chain, early exit: {analytic_ate:.6f} m; "
              f"identity trajectory {still:.6f} m)")
        check(np.isfinite(ate) and ate < still, "bi-objective ATE not finite or not below standing still")
    return out


def phase_bi_api(fb, I8, D16, card):
    """Phase 6f: N_API_PAIRS pairs through PhotoconsistencyOdometryBiObjective
    on the card with config_5_level_optimization_analytic (one K-GN-bi
    launch a pair per active level) against the level-major chain on the
    same frames and against the plain version; the warm-started chain, one
    launch per pair per level, against its plain version; one 480x640 pair
    of config_only_level_0_analytic. Returns (launches of the per-pair
    run, largest state difference)."""
    from phovo_tpu_torch.models import analytic, biobjective
    from phovo_tpu_torch.ops.prep import device_unit_intensity
    from phovo_tpu_torch.ops import pyramid as pyr
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.utils.config import config_from_dict

    dev = torch.device("cuda", 0)
    cfg_an = config_from_dict(ANALYTIC_PRESET)
    active = sum(1 for n in cfg_an.max_iterations if n > 0)
    n = N_API_PAIRS + 1
    depth_m = [torch.from_numpy(D16[k]).to(dev).to(torch.float32) * float(np.float32(DEPTH_SCALE)) for k in range(n)]
    Iapi, Dapi = torch.from_numpy(I8[:n]).to(dev), torch.stack(depth_m)
    K = [[TUM_FR1.fx, 0, TUM_FR1.cx], [0, TUM_FR1.fy, TUM_FR1.cy], [0, 0, 1]]

    def per_pair(cfg, pairs):
        vo = biobjective.PhotoconsistencyOdometryBiObjective(cfg, device=dev)
        vo.set_intrinsic_matrix(K)
        out = []
        for k in pairs:
            vo.set_source_frame(I8[k], depth_m[k])
            vo.set_target_frame(I8[k + 1], depth_m[k + 1])
            vo.set_initial_state_vector(np.zeros(6))
            out.append(vo.optimize())
        torch.cuda.synchronize()
        return type(out[0])(*(torch.stack(x) for x in zip(*out)))

    def plain(fn):
        with mock.patch.object(analytic, "fused_gn_level_batch", fb.fused_gn_level_batch_reference):
            return fn()

    lm = biobjective.align_sequence_biobjective(Iapi, Dapi, TUM_FR1, cfg_an)
    reset_counts(fb)
    kern = per_pair(cfg_an, range(N_API_PAIRS))
    launches, other = fb.LAUNCHES, fb.TR_LAUNCHES + fb.LIN_LAUNCHES
    reset_counts(fb)
    ref = plain(lambda: per_pair(cfg_an, range(N_API_PAIRS)))
    check(fb.LAUNCHES == 0, "the plain bi-objective per-pair run launched the kernel")
    bits = all(torch.equal(a, b) for a, b in zip(kern, lm))
    err = float((kern.state - ref.state).abs().max())
    lm_err = float((kern.state - lm.state).abs().max())
    # where a difference from the level-major chain can come from: K-GN-bi
    # gives the same bits for the same inputs whatever B is, so from the
    # inputs, built per pair here and for all frames at once there
    Ifl = device_unit_intensity(Iapi).to(torch.float32)
    prep_all = biobjective.prep_frame_biobjective(Ifl, Dapi, TUM_FR1, cfg_an)
    input_diff = {"pyramid": 0.0, "t6": 0.0, "gain": 0.0}
    for k in range(n):
        one = biobjective.prep_frame_biobjective(Ifl[k], Dapi[k], TUM_FR1, cfg_an)
        for level, (i0, _, t6, gain) in one.items():
            input_diff["pyramid"] = max(input_diff["pyramid"], float((i0 - prep_all[level][0][k]).abs().max()))
            input_diff["t6"] = max(input_diff["t6"], float((t6 - prep_all[level][2][k]).abs().max()))
            input_diff["gain"] = max(input_diff["gain"], float((gain - prep_all[level][3][k]).abs().max()))
    print(f"bi-objective per-pair API: {N_API_PAIRS} pairs, K-GN-bi launches {launches} (expected {active} x "
          f"{N_API_PAIRS}), other launches {other}, iterations {kern.iterations.tolist()}; max|state diff| kernel vs "
          f"plain {err:.3e}; against the level-major chain: the same bits {bits}, max|state diff| {lm_err:.3e}; "
          f"inputs one frame vs all frames at once, max|diff|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in input_diff.items()) + f" [{card}]")
    check(launches == active * N_API_PAIRS and other == 0,
          "the bi-objective optimize() did not launch K-GN-bi once per level per pair")
    check(err <= STATE_ATOL and lm_err <= STATE_ATOL, "bi-objective per-pair state diff")
    check(torch.equal(kern.iterations, ref.iterations) and torch.equal(kern.num_valid, ref.num_valid)
          and torch.equal(kern.iterations, lm.iterations), "bi-objective per-pair iterations or valid counts differ")
    check(bits or any(v > 0 for v in input_diff.values()),
          "the per-pair route differs from the level-major chain on the same inputs")
    worst = max(err, lm_err)

    reset_counts(fb)
    warm = biobjective.align_sequence_biobjective(Iapi, Dapi, TUM_FR1, cfg_an, warm_start=True)
    torch.cuda.synchronize()
    warm_launches = fb.LAUNCHES
    warm_plain = plain(lambda: biobjective.align_sequence_biobjective(Iapi, Dapi, TUM_FR1, cfg_an, warm_start=True))
    err = float((warm.state - warm_plain.state).abs().max())
    print(f"bi-objective warm start: {N_API_PAIRS} pairs, K-GN-bi launches {warm_launches}, max|state diff| kernel vs "
          f"plain {err:.3e}, max|state - zero-init state| {float((warm.state - lm.state).abs().max()):.3e} [{card}]")
    check(warm_launches == active * N_API_PAIRS, "the bi-objective warm chain did not launch once per level per pair")
    check(fb.LAUNCHES == fb.BI_LAUNCHES == warm_launches,
          "the plain bi-objective warm run launched the kernel, or the chain another variant")
    check(err <= STATE_ATOL and torch.equal(warm.iterations, warm_plain.iterations),
          "bi-objective warm chain differs from plain")
    worst = max(worst, err)

    cfg0 = config_from_dict(LEVEL0_PRESET)
    reset_counts(fb)
    t0 = time.perf_counter()
    one = per_pair(cfg0, [0])
    wall = time.perf_counter() - t0
    its = int(one.iterations[0, 0])
    print(f"bi-objective config_only_level_0_analytic: one {SHAPE[0]}x{SHAPE[1]} pair, K-GN-bi launches {fb.LAUNCHES}, "
          f"iterations {its}, {wall:.3f} s, final ||J^T r|| {float(one.gradient_norm[0, 0]):.3f} [{card}]")
    check(fb.LAUNCHES == fb.BI_LAUNCHES == 1 and bool(torch.isfinite(one.state).all()),
          "the level-0 preset did not run once through K-GN-bi")
    if its <= NEAREST_ITERATIONS:
        ref0 = plain(lambda: per_pair(cfg0, [0]))
        err = float((one.state - ref0.state).abs().max())
        print(f"bi-objective config_only_level_0_analytic: kernel vs plain max|state diff| {err:.3e}")
        check(err <= STATE_ATOL and torch.equal(one.iterations, ref0.iterations), "bi level-0 preset differs from plain")
        worst = max(worst, err)
    return launches, worst


def phase_bi_timing(Is, Ds, card):
    """Phase 7d: the bi-objective chain per 256 pairs (fixed-75 and early
    exit at 300) beside the analytic chain, in turns (analytic, bi, bi,
    analytic); the bi prep layer beside the analytic one; K-GN-bi per level
    against its plain version (plain, kernel, kernel, plain) and against
    K-GN on the same frames; K-GN-bi at B = 1 on a 480x640 level, 3
    nearest iterations; align_biobjective a VGA pair beside align_analytic.
    Returns the kernel's record fields."""
    from phovo_tpu_torch.models import analytic, biobjective
    from phovo_tpu_torch.models.analytic import prep_frame_analytic
    from phovo_tpu_torch.ops import fused_batch as fb
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.ops.pyramid import level_shape
    from phovo_tpu_torch.utils.config import config_from_dict

    dev = Is.device
    n_pairs = Is.shape[0] - 1
    cfg_fixed, cfg_ee = bench_config(0.0), bench_config(300.0)
    for name, cfg in (("fixed-75", cfg_fixed), ("early exit at 300", cfg_ee)):
        a1 = cuda_ms(lambda: analytic.align_sequence(Is, Ds, TUM_FR1, cfg), REPEATS)
        b1 = cuda_ms(lambda: biobjective.align_sequence_biobjective(Is, Ds, TUM_FR1, cfg), REPEATS)
        b2 = cuda_ms(lambda: biobjective.align_sequence_biobjective(Is, Ds, TUM_FR1, cfg), REPEATS)
        a2 = cuda_ms(lambda: analytic.align_sequence(Is, Ds, TUM_FR1, cfg), REPEATS)
        print(f"bi-objective chain {name}: {1e3 * n_pairs / ((b1 + b2) / 2):.1f} pairs/s ({b1:.3f}, {b2:.3f} ms / "
              f"{n_pairs} pairs); analytic chain beside it {a1:.3f}, {a2:.3f} ms [{card}]")
    ms_an = cuda_ms(lambda: prep_frame_analytic(Is, Ds, TUM_FR1, cfg_fixed), REPEATS)
    ms_bi = cuda_ms(lambda: biobjective.prep_frame_biobjective(Is, Ds, TUM_FR1, cfg_fixed), REPEATS)
    print(f"layer bi-objective prep (pyramids, Scharr of intensity and depth, geometry, six-channel stacks, gains of "
          f"{Is.shape[0]} frames): {ms_bi:.3f} ms; analytic prep beside it {ms_an:.3f} ms [{card}]")

    packs = pair_packs(biobjective.prep_frame_biobjective(Is, Ds, TUM_FR1, cfg_fixed))
    photo = pair_packs(prep_frame_analytic(Is, Ds, TUM_FR1, cfg_fixed))
    rec = dict(ms=0.0, plain_ms=0.0, photometric_ms=0.0)
    n_bytes = flops = 0.0
    for level, (i0, geom, t6, gains) in sorted(packs.items(), reverse=True):
        H, W = level_shape(SHAPE, level)
        zero = torch.zeros((n_pairs, 6), device=dev)
        args = (i0, geom, t6, TUM_FR1.at_level(level), zero, cfg_fixed.max_iterations[level], 0.0, 1.0)
        kw = dict(H=H, W=W, sampling="nearest", depth_gains=gains)
        p1 = cuda_ms(lambda: fb.fused_gn_level_batch_reference(*args, **kw), 2)
        k1 = cuda_ms(lambda: fb.fused_gn_level_batch(*args, **kw), REPEATS)
        g = cuda_ms(lambda: fb.fused_gn_level_batch(*photo[level], *args[3:], H=H, W=W, sampling="nearest"), REPEATS)
        k2 = cuda_ms(lambda: fb.fused_gn_level_batch(*args, **kw), REPEATS)
        p2 = cuda_ms(lambda: fb.fused_gn_level_batch_reference(*args, **kw), 2)
        res = fb.fused_gn_level_batch(*args, **kw)
        rec["ms"] += (k1 + k2) / 2
        rec["plain_ms"] += (p1 + p2) / 2
        rec["photometric_ms"] += g
        n_bytes += nbytes(i0, geom, t6, gains, zero, *res)
        flops += float(res.iterations.double().sum()) * H * W * (GN_FLOPS["nearest"] + BI_EXTRA_FLOPS["nearest"])
        print(f"layer bi-objective level kernel: level {level} {H}x{W}, {n_pairs} pairs x "
              f"{cfg_fixed.max_iterations[level]} it: kernel {(k1 + k2) / 2:.3f} ms ({k1:.3f}, {k2:.3f}), plain "
              f"{(p1 + p2) / 2:.3f} ms ({p1:.3f}, {p2:.3f}), photometric K-GN on the same frames {g:.3f} ms [{card}]")
    del packs, photo
    rec["bound_ms"], rec["bound_by"] = bound(n_bytes, flops)
    print(f"fused_gn_level_batch_bi: bench chain {rec['ms']:.3f} ms (photometric K-GN {rec['photometric_ms']:.3f} ms), "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}) [{card}]")

    # B4's workload: K-GN-bi at B = 1, one pair's 480x640 level, 3 nearest
    # iterations (the B3 row's)
    cfg0 = config_from_dict(LEVEL0_PRESET)
    one = pair_packs(biobjective.prep_frame_biobjective(Is[:2], Ds[:2], TUM_FR1, cfg0))[0]
    gn1 = (*one[:3], TUM_FR1, torch.zeros((1, 6), device=dev), NEAREST_ITERATIONS, 0.0, 1.0)
    gn1_kw = dict(H=SHAPE[0], W=SHAPE[1], sampling="nearest", depth_gains=one[3])
    p1 = cuda_ms(lambda: fb.fused_gn_level_batch_reference(*gn1, **gn1_kw), 3)
    k1 = cuda_ms(lambda: fb.fused_gn_level_batch(*gn1, **gn1_kw), REPEATS)
    k2 = cuda_ms(lambda: fb.fused_gn_level_batch(*gn1, **gn1_kw), REPEATS)
    p2 = cuda_ms(lambda: fb.fused_gn_level_batch_reference(*gn1, **gn1_kw), 3)
    one_bound = bound(nbytes(*one, gn1[4], *fb.fused_gn_level_batch(*gn1, **gn1_kw)),
                      NEAREST_ITERATIONS * SHAPE[0] * SHAPE[1] * (GN_FLOPS["nearest"] + BI_EXTRA_FLOPS["nearest"]))
    rec["b1_ms"], rec["b1_plain_ms"], rec["b1_bound_ms"] = (k1 + k2) / 2, (p1 + p2) / 2, one_bound[0]
    print(f"layer bi-objective level kernel at B = 1 (B4, the per-pair level): {SHAPE[0]}x{SHAPE[1]}, "
          f"{NEAREST_ITERATIONS} nearest iterations, {fb.cluster_size(*SHAPE)} blocks: kernel {(k1 + k2) / 2:.3f} ms "
          f"({k1:.3f}, {k2:.3f}), plain {(p1 + p2) / 2:.3f} ms ({p1:.3f}, {p2:.3f}), bound {one_bound[0]:.4f} ms "
          f"({one_bound[1]}) [{card}]")

    cfg_an = config_from_dict(ANALYTIC_PRESET)
    zero6 = torch.zeros(6, device=dev)
    pair = (Is[0], Ds[0], Is[1], Ds[1], TUM_FR1, zero6, cfg_an)
    ms_an = cuda_ms(lambda: analytic.align_analytic(*pair), REPEATS)
    ms_bi = cuda_ms(lambda: biobjective.align_biobjective(*pair), REPEATS)
    print(f"per-pair bi-objective route: align_biobjective {ms_bi:.3f} ms a VGA pair (analytic preset, 3 launches "
          f"at B = 1); align_analytic beside it {ms_an:.3f} ms [{card}]")
    return rec


# The keyframe tracker (phases 4d and 7e): KF_FRAMES VGA frames of the
# synthetic plane along an out-and-back loop, tracked KF_CHUNK frames a
# dispatch, with thresholds that promote a keyframe every ~5 frames and
# find closures on the way back: tests/test_keyframe.py's, with a 6 cm
# promotion and the loop weight both packages default to (10). With 8 cm
# and weight 50 the analytic preset's ATE after finalize (10.34 mm on an
# H100) sat just above the frame chain's (10.26 mm). That is the
# algorithm's, not the port's: tools/keyframe_ate.py runs phovo_tpu and
# this package on the same loop at 240x320 on the CPU, and at both
# settings they make the same keyframes and closures, with ATEs within
# 0.2 mm; there the analytic preset's finalize raises the ATE above the
# tracked poses' in both packages (20.8 -> 27.9 mm at 6 cm, phovo_tpu).
KF_FRAMES = 64
KF_CHUNK = 16
KF_OPTIONS = dict(kf_translation=0.06, kf_rotation=0.1, loop_radius=0.15, loop_min_gap=2, loop_weight=10.0)
# serving (phases 4e and 7e): S streams of T frames, the 257 main-path
# frames cut into 8 streams that share their end frames, so their 256
# pairs are the frame chain's
SERVE_STREAMS = 8
SERVE_FRAMES = 33
# The keyframe path's ATE must not exceed the frame chain's on the same
# frames, unless both are below this: on the noise-free plane the ceres
# chain's ATE is a fraction of a millimetre (0.22 mm over 24 frames at
# 240x320, in the CPU rehearsal), float32 noise of converged alignments
# that neither route can beat
KF_ATE_FLOOR = 1e-3
# phase 3e: the keyframe (the middle of the 9 frames) and its 8 targets
SHARED_KF = 4
SHARED_TARGETS = [0, 1, 2, 3, 5, 6, 7, 8]
SHARED_VARIANTS = ("none", "huber", "tukey", "esm")


def shared_packs(prep: dict) -> dict:
    """Per-frame packs -> the keyframe-tracking layout: the keyframe's
    (i0 (1, N), geom (1, GR, N)) and the 8 targets' t_all."""
    kf = slice(SHARED_KF, SHARED_KF + 1)
    return {level: (i0[kf], geom[kf], t_all[SHARED_TARGETS]) for level, (i0, geom, t_all) in prep.items()}


def replicated(i0, geom, t_all):
    """The shared source repeated once per target."""
    B = t_all.shape[0]
    return i0.expand(B, -1).contiguous(), geom.expand(B, -1, -1).contiguous()


def phase_shared(fb, fused_ops, I9, D9, card):
    """Phase 3e: the shared-source modes and the multi-stream level against
    their plain versions on 8 VGA targets of one keyframe. K-GN shared with
    'none', huber, tukey and ESM at every active level of the analytic
    preset, bilinear over its whole schedule and nearest over
    NEAREST_ITERATIONS (costs split by attribute_nearest_cost); K-TR shared
    at the five levels of the ceres preset (compare_tr_levels: the budget,
    the preset's tolerances and an early-exit case per stopping test); each
    shared launch against the replicated launch, bit for bit; and
    fused_gn_level_multi at S = 8 against its plain version and, bit for
    bit, against fused_gn_level_batch on the same packs. Returns the
    largest state differences (K-GN shared, K-TR shared, multi)."""
    from phovo_tpu_torch.models.analytic import prep_frame_analytic
    from phovo_tpu_torch.ops import pyramid as pyr
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.ops.pyramid import level_shape
    from phovo_tpu_torch.utils.config import config_from_dict

    cfg_an = config_from_dict(ANALYTIC_PRESET)
    gn_err = 0.0
    for variant in SHARED_VARIANTS:
        cfg = variant_config(cfg_an, variant)
        packs = shared_packs(prep_frame_analytic(I9, D9, TUM_FR1, cfg))
        for sampling in ("nearest", "bilinear"):
            bilinear = sampling == "bilinear"
            iterations = {level: n if bilinear else min(n, NEAREST_ITERATIONS)
                          for level, n in enumerate(cfg.max_iterations)}
            gn_err = max(gn_err, compare_levels(fb, packs, TUM_FR1, iterations, sampling, card, cfg,
                                                attribute=not bilinear, explain_edge=bilinear)[0])
            for level, (i0, geom, t_all) in packs.items():
                H, W = level_shape(SHAPE, level)
                args = (t_all, TUM_FR1.at_level(level), torch.zeros((t_all.shape[0], 6), device=t_all.device),
                        iterations[level], 0.0, 1.0)
                kw = dict(H=H, W=W, sampling=sampling, **gn_variant_kw(cfg))
                one = fb.fused_gn_level_batch(i0, geom, *args, **kw)
                rep = fb.fused_gn_level_batch(*replicated(i0, geom, t_all), *args, **kw)
                check(all(torch.equal(a, b) for a, b in zip(one, rep)),
                      f"K-GN shared {variant} {sampling} level {level}: not the replicated launch's bits")
        print(f"K-GN shared {variant}: the shared launch gives the replicated launch's bits at every level, "
              f"both samplings [{card}]")
        del packs

    cfg_tr = config_from_dict(CERES_PRESET)
    tr_packs = shared_packs(prep_frame_analytic(I9, D9, TUM_FR1, cfg_tr))
    tr_err = compare_tr_levels(fb, tr_packs, TUM_FR1, cfg_tr, card, explain_edge=True)
    for level, (i0, geom, t_all) in tr_packs.items():
        H, W = level_shape(SHAPE, level)
        args = (t_all, TUM_FR1.at_level(level), torch.zeros((t_all.shape[0], 6), device=t_all.device),
                cfg_tr.trust_region_options(level))
        one = fb.fused_tr_level_batch(i0, geom, *args, H=H, W=W)
        rep = fb.fused_tr_level_batch(*replicated(i0, geom, t_all), *args, H=H, W=W)
        check(all(torch.equal(a, b) for a, b in zip(one, rep)), f"K-TR shared level {level}: not the replicated bits")
    print(f"K-TR shared: the shared launch gives the replicated launch's bits at all five levels [{card}]")
    del tr_packs

    multi_err = 0.0
    for variant in ("none", "huber"):
        cfg = variant_config(cfg_an, variant)
        L, scales = cfg.num_levels, cfg.gradient_scales
        ints, deps = pyr.build_pyramid(I9, L), pyr.build_pyramid(D9, L)
        gx, gy = pyr.build_gradient_pyramid(ints, scales)
        pairs = pair_packs(prep_frame_analytic(I9, D9, TUM_FR1, cfg))
        for sampling in ("nearest", "bilinear"):
            for level in sorted(pairs, reverse=True):
                H, W = level_shape(SHAPE, level)
                n = cfg.max_iterations[level] if sampling == "bilinear" else NEAREST_ITERATIONS
                intr = TUM_FR1.at_level(level)
                init = torch.zeros((8, 6), device=I9.device)
                args = (ints[level][:-1], deps[level][:-1], torch.cat([ints[level][1:], gx[level][1:], gy[level][1:]], -2),
                        intr, init, cfg.min_depth, cfg.max_depth, n, 0.0, 1.0, sampling, cfg.robust_loss,
                        cfg.robust_delta)
                before = fused_ops.MULTI_LAUNCHES
                k = fused_ops.fused_gn_level_multi(*args)
                check(fused_ops.MULTI_LAUNCHES == before + 1, "fused_gn_level_multi did not launch once")
                p = fused_ops.fused_gn_level_multi_reference(*args)
                b = fb.fused_gn_level_batch(*pairs[level], intr, init, n, 0.0, 1.0, H=H, W=W, sampling=sampling,
                                            robust_loss=cfg.robust_loss, robust_delta=cfg.robust_delta)
                torch.cuda.synchronize()
                err = float((k.state - p.state).abs().max())
                bits = all(torch.equal(x, y) for x, y in zip(k, b))
                same = torch.equal(k.iterations, p.iterations) and torch.equal(k.num_valid, p.num_valid)
                print(f"multi-stream level (B7 on K-GN) {variant}: level {level} {H}x{W} {sampling} S = 8 x {n} it: "
                      f"max|state diff| vs plain {err:.3e}, iterations and valid counts equal {same}, the bits of "
                      f"K-GN on the same packs {bits} [{card}]")
                check(err <= STATE_ATOL and same and bits, f"multi-stream level {variant} {sampling} level {level}")
                multi_err = max(multi_err, err)
        del pairs, ints, deps, gx, gy
    return gn_err, tr_err, multi_err


def loop_states(n: int) -> list:
    """n camera states out along +x to 0.4 m (a slight yaw, a wobble in y)
    and back near the start."""
    half = n // 2
    xs = np.concatenate([np.linspace(0.0, 0.4, half + 1), np.linspace(0.4, 0.02, n - half - 1)])
    return [np.array([x, 0.01 * np.sin(k / 4.0), 0.0, 0.05 * x, 0.0, 0.0]) for k, x in enumerate(xs)]


def keyframe_frames(se3):
    """KF_FRAMES RGBDFrames of the plane along loop_states at 480x640
    (uint8 intensity, uint16 depth counts), and the ground-truth
    camera-in-world poses."""
    from phovo_tpu_torch.datasets.tum import RGBDFrame
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.utils.synthetic import render_plane

    frames, gts = [], []
    for k, st in enumerate(loop_states(KF_FRAMES)):
        T = se3.pose_matrix_np(st)
        I, D = render_plane(TUM_FR1, SHAPE, T)
        frames.append(RGBDFrame(float(k), float(k), np.round(I * 255.0).astype(np.uint8),
                                np.round(D / DEPTH_SCALE).astype(np.uint16)))
        gts.append(np.linalg.inv(T))
    return frames, gts


def keyframe_run(frames, cfg, ceres, plain=False, timers=None):
    """One KeyframeVisualOdometry.run_chunked (KF_CHUNK, raw depth counts)
    and finalize() on the card: (the tracker, its poses before finalize,
    its poses after, {tracking dispatches, those of a single frame,
    closure batches or alignments, run_chunked's and finalize's seconds}). plain: the level kernels' plain
    versions in place of the wrappers. timers: a dict that collects the
    seconds of the tracking dispatches and of the closures, each ended by
    a synchronize."""
    import contextlib

    from phovo_tpu_torch.models import analytic, autodiff, keyframe
    from phovo_tpu_torch.ops import fused as fused_ops
    from phovo_tpu_torch.ops import fused_batch as fb
    from phovo_tpu_torch.ops.camera import TUM_FR1

    vo = (autodiff.PhotoconsistencyOdometryAutodiff if ceres else analytic.PhotoconsistencyOdometryAnalytic)(cfg)
    vo.set_intrinsic_matrix([[TUM_FR1.fx, 0, TUM_FR1.cx], [0, TUM_FR1.fy, TUM_FR1.cy], [0, 0, 1]])
    kvo = keyframe.KeyframeVisualOdometry(vo, **KF_OPTIONS)
    counts = {"dispatches": 0, "closures": 0, "single": 0}

    def counted(fn, key):
        def wrapper(*a, **kw):
            counts[key] += 1
            if key == "dispatches":  # a chunk of one frame is an ordinary B = 1 launch
                counts["single"] += int(a[1].shape[0] == 1)
            if timers is None:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            timers[key] = timers.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    track = "track_chunk_levelmajor_tr" if ceres else "track_chunk_levelmajor"
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(keyframe, track, counted(getattr(keyframe, track), "dispatches")))
        if ceres:
            kvo._align = counted(kvo._align, "closures")
        else:
            stack.enter_context(mock.patch.object(keyframe, "align_batch", counted(keyframe.align_batch, "closures")))
        if plain:
            for module, name, ref in ((analytic, "fused_gn_level_batch", fb.fused_gn_level_batch_reference),
                                      (autodiff, "fused_tr_level_batch", fb.fused_tr_level_batch_reference),
                                      (fused_ops, "fused_tr_level_batch", fb.fused_tr_level_batch_reference)):
                stack.enter_context(mock.patch.object(module, name, ref))
            # the plain versions copy host scalars to the card, which a CUDA
            # graph cannot capture: the object API's pairs run eagerly
            stack.enter_context(mock.patch.object(vo, "capturable", lambda *a: False))
        t0 = time.perf_counter()
        tracked = list(kvo.run_chunked(frames, chunk=KF_CHUNK, depth_scale=DEPTH_SCALE))
        torch.cuda.synchronize()
        counts["run_chunked_s"] = time.perf_counter() - t0
        before = [tf.pose.copy() for tf in tracked]
        t0 = time.perf_counter()
        after = [tf.pose.copy() for tf in kvo.finalize()]
        torch.cuda.synchronize()
        counts["finalize_s"] = time.perf_counter() - t0
    return kvo, before, after, counts


def pose_ate(traj, poses, gts):
    """ATE rmse of camera-in-world poses (frame 0 the identity) against
    the ground truth, metres."""
    ts = np.arange(len(gts), dtype=np.float64)
    return traj.absolute_trajectory_error(traj.Trajectory.from_poses(ts, np.stack(poses)),
                                          traj.Trajectory.from_poses(ts, np.stack(gts)))["rmse"]


def phase_keyframe(fb, se3, traj, frames, gts, card):
    """Phase 4d: the keyframe main path at 480x640. KF_FRAMES frames along
    an out-and-back loop through KeyframeVisualOdometry.run_chunked over
    PhotoconsistencyOdometryAnalytic (the analytic preset) and over
    PhotoconsistencyOdometryAutodiff (the ceres preset), each with the
    launch counts set to 0 just before and read just after, then once more
    through the plain versions. Checks: at least 3 keyframes and a loop
    closure; the shared-source launches = active levels x chunk dispatches,
    and the closures' launches (analytic: K-GN, active levels a closure
    batch; ceres: K-TR at B = 1, active levels a candidate); kernel vs
    plain: the same keyframes, edges and closures, poses within
    STATE_ATOL; finalize()'s ATE below standing still and not above the
    frame chain's on the same frames (or both below KF_ATE_FLOOR). Returns {backend: (shared launches,
    largest pose difference)}."""
    from phovo_tpu_torch.models import analytic, autodiff
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.utils.config import config_from_dict

    dev = torch.device("cuda", 0)
    still = pose_ate(traj, [np.eye(4)] * len(gts), gts)
    I = torch.from_numpy(np.stack([f.intensity for f in frames])).to(dev)
    D = torch.from_numpy(np.stack([f.depth for f in frames])).to(dev)
    out = {}
    for name, cfg, ceres, chunk_fn in (
        ("analytic", config_from_dict(ANALYTIC_PRESET), False, analytic.align_sequence_chunk),
        ("ceres", config_from_dict(CERES_PRESET), True, autodiff.align_sequence_chunk_autodiff),
    ):
        active = sum(1 for n in cfg.max_iterations if n > 0)
        reset_counts(fb)
        kvo, before, after, counts = keyframe_run(frames, cfg, ceres)
        shared = fb.TR_SHARED_LAUNCHES if ceres else fb.SHARED_LAUNCHES
        other = (fb.TR_LAUNCHES - fb.TR_SHARED_LAUNCHES) if ceres else (fb.LAUNCHES - fb.SHARED_LAUNCHES)
        wrong = fb.LAUNCHES if ceres else fb.TR_LAUNCHES
        lc = [(c.from_kf, c.to_kf) for c in kvo.loop_closures]
        multi_frame = counts["dispatches"] - counts["single"]
        print(f"keyframe path {name}: {len(frames)} {SHAPE[0]}x{SHAPE[1]} frames, chunk {KF_CHUNK}: keyframes at "
              f"frames {[k.frame_index for k in kvo.keyframes]}, loop closures {lc}; tracking dispatches "
              f"{counts['dispatches']} ({counts['single']} of one frame), shared-source launches {shared} (expected "
              f"{active} x {multi_frame}), closure {'alignments' if ceres else 'batches'} {counts['closures']}; the "
              f"closures' and one-frame dispatches' launches {other} (expected {active} x "
              f"{counts['closures'] + counts['single']}), other kernel launches {wrong} [{card}]")
        check(len(kvo.keyframes) >= 3 and len(lc) >= 1, f"keyframe {name}: fewer than 3 keyframes or no closure")
        check(shared == active * multi_frame and multi_frame > 0,
              f"keyframe {name}: not one shared-source launch per active level a dispatch")
        check(other == active * (counts["closures"] + counts["single"]) and counts["closures"] > 0 and wrong == 0,
              f"keyframe {name}: the closures did not launch once per active level")
        reset_counts(fb)
        pk, pbefore, pafter, _ = keyframe_run(frames, cfg, ceres, plain=True)
        check(fb.LAUNCHES + fb.TR_LAUNCHES == 0, f"keyframe {name}: the plain run launched a kernel")
        same = ([k.frame_index for k in kvo.keyframes] == [k.frame_index for k in pk.keyframes]
                and [(i, j) for i, j, _ in kvo.odometry_edges] == [(i, j) for i, j, _ in pk.odometry_edges]
                and lc == [(c.from_kf, c.to_kf) for c in pk.loop_closures])
        err = max(float(np.abs(a - b).max()) for a, b in zip(before + after, pbefore + pafter))
        ate = pose_ate(traj, [np.eye(4)] + after, gts)
        ate_tracked = pose_ate(traj, [np.eye(4)] + before, gts)
        chain, _, _ = chunk_fn(I[0], D[0].to(torch.float32) * float(np.float32(DEPTH_SCALE)), I[1:], D[1:],
                               TUM_FR1, cfg, depth_scale=DEPTH_SCALE)
        chain_poses = se3.integrate_trajectory(chain.state).cpu().double().numpy()
        chain_ate = pose_ate(traj, [np.eye(4)] + list(chain_poses), gts)
        print(f"keyframe path {name}: kernel vs plain: the same keyframes, edges and closures {same}, max|pose diff| "
              f"{err:.3e}; ATE rmse after finalize {ate:.6f} m (tracked {ate_tracked:.6f} m; the frame chain "
              f"{chain_ate:.6f} m; standing still {still:.6f} m) [{card}]")
        check(same and err <= STATE_ATOL, f"keyframe {name}: kernel and plain runs differ")
        check(np.isfinite(ate) and ate < still and ate <= max(chain_ate, KF_ATE_FLOOR),
              f"keyframe {name}: ATE {ate} not below standing still or above the frame chain's {chain_ate}")
        out[name] = (shared, err)
    return out


def serve_streams(I8, D16, dev):
    """The 257 main-path frames as SERVE_STREAMS streams of SERVE_FRAMES
    (stream s: frames 32 s .. 32 s + 32): uint8 intensities, uint16 depth
    counts and metric depths, on the card."""
    step = SERVE_FRAMES - 1
    idx = np.stack([np.arange(s * step, s * step + SERVE_FRAMES) for s in range(SERVE_STREAMS)])
    I = torch.from_numpy(I8[idx]).to(dev)
    D16s = torch.from_numpy(D16[idx]).to(dev)
    return I, D16s, D16s.to(torch.float32) * float(np.float32(DEPTH_SCALE))


def phase_serving(fb, fused_ops, I8, D16, card):
    """Phase 4e: serving at 480x640 with the analytic preset: 8 streams x
    33 frames through align_sequences (all 256 zero-init pairs in one
    launch a level), serve_sequences_chunk in two chunks (uint8 frames,
    uint16 depth counts) and align_sequences_multi (the B7 route, one
    multi-stream launch a level a time step), each with the counts set to
    0 just before and read just after and once more through the plain
    versions; the flattened streams against each stream's own chain (the
    same bits) and the three routes against each other. Returns (the
    multi-stream launches, the largest state difference)."""
    from phovo_tpu_torch.models import analytic
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.parallel import batch
    from phovo_tpu_torch.utils.config import config_from_dict

    dev = torch.device("cuda", 0)
    cfg = config_from_dict(ANALYTIC_PRESET)
    active = sum(1 for n in cfg.max_iterations if n > 0)
    I, D16s, D = serve_streams(I8, D16, dev)
    S, T = I.shape[:2]

    def plain_gn():
        return mock.patch.object(analytic, "fused_gn_level_batch", fb.fused_gn_level_batch_reference)

    def compare(k, p, what, bits_expected=False):
        err = float((k.state - p.state).abs().max())
        same = torch.equal(k.iterations, p.iterations) and torch.equal(k.num_valid, p.num_valid)
        bits = all(torch.equal(a, b) for a, b in zip(k, p))
        print(f"serving {what}: max|state diff| {err:.3e}, iterations and valid counts equal {same}, the same bits "
              f"{bits} [{card}]")
        check(err <= STATE_ATOL and same and (bits or not bits_expected), f"serving {what} differ")
        return err

    reset_counts(fb)
    res, poses = batch.align_sequences(I, D, TUM_FR1, cfg)
    torch.cuda.synchronize()
    launches = fb.LAUNCHES
    print(f"serving align_sequences: {S} streams x {T} frames, K-GN launches {launches} (expected {active}), "
          f"iterations per level (mean) {res.iterations.double().mean(dim=(0, 1)).cpu().numpy().round(3).tolist()}")
    check(launches == active and tuple(res.state.shape) == (S, T - 1, 6), "align_sequences did not flatten the streams")
    check(bool(torch.isfinite(res.state).all()) and tuple(poses.shape) == (S, T - 1, 4, 4), "serving states or poses")
    reset_counts(fb)
    with plain_gn():
        plain, _ = batch.align_sequences(I, D, TUM_FR1, cfg)
    check(fb.LAUNCHES == 0, "the plain serving run launched the kernel")
    worst = compare(res, plain, "align_sequences kernel vs plain")
    own = [analytic.align_sequence(I[s], D[s], TUM_FR1, cfg) for s in range(S)]
    worst = max(worst, compare(res, type(res)(*(torch.stack(x) for x in zip(*own))),
                               "align_sequences vs each stream's own align_sequence", bits_expected=True))

    reset_counts(fb)
    parts, carry_i, carry_d = [], I[:, 0], D[:, 0]
    for lo, hi in ((1, (T + 1) // 2), ((T + 1) // 2, T)):
        r, p, carry_i, carry_d = batch.serve_sequences_chunk(carry_i, carry_d, I[:, lo:hi], D16s[:, lo:hi], TUM_FR1,
                                                             cfg, depth_scale=DEPTH_SCALE)
        parts.append((r, p))
    torch.cuda.synchronize()
    print(f"serving serve_sequences_chunk: two chunks, K-GN launches {fb.LAUNCHES} (expected {active} x 2)")
    check(fb.LAUNCHES == 2 * active, "serve_sequences_chunk did not launch once per level a chunk")
    served = type(res)(*(torch.cat(x, dim=1) for x in zip(*(r for r, _ in parts))))
    worst = max(worst, compare(served, res, "serve_sequences_chunk vs align_sequences"))
    glued = torch.cat([parts[0][1], parts[0][1][:, -1:] @ parts[1][1]], dim=1)
    pose_err = float((glued - poses).abs().max())
    print(f"serving chunk-relative poses composed across the two chunks vs align_sequences' poses: max|diff| "
          f"{pose_err:.3e} [{card}]")
    check(pose_err <= 1e-4, "the chunk-relative poses do not compose to the whole stream's")

    reset_counts(fb)
    multi, _ = batch.align_sequences_multi(I, D, TUM_FR1, cfg)
    torch.cuda.synchronize()
    multi_launches, gn_launches = fused_ops.MULTI_LAUNCHES, fb.LAUNCHES
    print(f"serving align_sequences_multi (B7 on K-GN): {T - 1} time steps, multi-stream launches {multi_launches} "
          f"(expected {active} x {T - 1}), K-GN launches {gn_launches}")
    check(multi_launches == active * (T - 1) and gn_launches == multi_launches,
          "align_sequences_multi did not launch one multi-stream level a level a time step")
    with mock.patch.object(analytic, "fused_gn_level_multi_packs", fb.fused_gn_level_batch_reference):
        multi_plain, _ = batch.align_sequences_multi(I, D, TUM_FR1, cfg)
    check(fused_ops.MULTI_LAUNCHES == multi_launches, "the plain multi-stream run launched the kernel")
    worst = max(worst, compare(multi, multi_plain, "align_sequences_multi kernel vs plain"))
    worst = max(worst, compare(multi, res, "align_sequences_multi vs align_sequences"))
    return multi_launches, worst


def timed_levels(name, levels, run_kernel, run_plain, run_other=None, card=""):
    """Per level (plain, kernel, [other,] kernel, plain) by cuda_ms: sums of
    the kernel's and the plain version's ms (and the other's)."""
    total = {"ms": 0.0, "plain_ms": 0.0, "other_ms": 0.0}
    for level, label in levels:
        p1 = cuda_ms(lambda: run_plain(level), 2)
        k1 = cuda_ms(lambda: run_kernel(level), REPEATS)
        o = cuda_ms(lambda: run_other(level), REPEATS) if run_other else 0.0
        k2 = cuda_ms(lambda: run_kernel(level), REPEATS)
        p2 = cuda_ms(lambda: run_plain(level), 2)
        total["ms"] += (k1 + k2) / 2
        total["plain_ms"] += (p1 + p2) / 2
        total["other_ms"] += o
        print(f"layer {name}: {label}: kernel {(k1 + k2) / 2:.4f} ms ({k1:.4f}, {k2:.4f}), plain {(p1 + p2) / 2:.3f} ms "
              f"({p1:.3f}, {p2:.3f})" + (f", beside it {o:.4f} ms" if run_other else "") + f" [{card}]")
    return total


def phase_keyframe_serving_timing(fb, fused_ops, frames, I8, D16, card):
    """Phase 7e: the keyframe path's frames/s (analytic and ceres) with the
    tracking dispatches, the closures and finalize() timed apart (a second
    run whose wrappers synchronize); align_sequences pairs/s at S = 8
    beside align_sequence on the same 256 pairs, in turns;
    align_sequences_multi ms a time step; per level K-GN shared against
    K-GN replicated on one tracked chunk (KF_CHUNK targets, the analytic
    preset), K-TR shared (the ceres preset) and fused_gn_level_multi (S =
    8, the analytic preset) against their plain versions; each kernel's
    bound, the shared pack's bytes counted once. Returns the three
    kernels' record fields."""
    from phovo_tpu_torch.models import analytic
    from phovo_tpu_torch.models.analytic import prep_frame_analytic, prep_frame_targets, prep_keyframe
    from phovo_tpu_torch.ops import pyramid as pyr
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.ops.pyramid import level_shape
    from phovo_tpu_torch.parallel import batch
    from phovo_tpu_torch.utils.config import config_from_dict

    dev = torch.device("cuda", 0)
    cfg_an, cfg_tr = config_from_dict(ANALYTIC_PRESET), config_from_dict(CERES_PRESET)
    for name, cfg, ceres in (("analytic", cfg_an, False), ("ceres", cfg_tr, True)):
        keyframe_run(frames, cfg, ceres)  # warm-up
        kvo, _, _, counts = keyframe_run(frames, cfg, ceres)
        split = {}
        _, _, _, split_counts = keyframe_run(frames, cfg, ceres, timers=split)
        n, wall = len(frames) - 1, counts["run_chunked_s"]
        print(f"keyframe path {name}: run_chunked {n} frames in {wall:.3f} s, {n / wall:.1f} frames/s, finalize "
              f"{counts['finalize_s'] * 1e3:.2f} ms ({len(kvo.keyframes)} keyframes, {len(kvo.loop_closures)} "
              f"closures); synchronized split: {counts['dispatches']} tracking dispatches "
              f"{split['dispatches'] * 1e3:.1f} ms, {counts['closures']} closure "
              f"{'alignments' if ceres else 'batches'} {split.get('closures', 0.0) * 1e3:.1f} ms, finalize "
              f"{split_counts['finalize_s'] * 1e3:.2f} ms, run_chunked {split_counts['run_chunked_s'] * 1e3:.1f} ms "
              f"[{card}]")

    I, _, D = serve_streams(I8, D16, dev)
    S, T = I.shape[:2]
    chain_I = torch.cat([I[0, :1], I[:, 1:].reshape(-1, *SHAPE)])
    chain_D = torch.cat([D[0, :1], D[:, 1:].reshape(-1, *SHAPE)])
    c1 = cuda_ms(lambda: analytic.align_sequence(chain_I, chain_D, TUM_FR1, cfg_an), REPEATS)
    s1 = cuda_ms(lambda: batch.align_sequences(I, D, TUM_FR1, cfg_an), REPEATS)
    s2 = cuda_ms(lambda: batch.align_sequences(I, D, TUM_FR1, cfg_an), REPEATS)
    c2 = cuda_ms(lambda: analytic.align_sequence(chain_I, chain_D, TUM_FR1, cfg_an), REPEATS)
    n_pairs = S * (T - 1)
    print(f"serving align_sequences, {S} streams x {T} frames: {1e3 * n_pairs / ((s1 + s2) / 2):.1f} pairs/s ({s1:.3f}, "
          f"{s2:.3f} ms / {n_pairs} pairs); align_sequence on the same {n_pairs} pairs {c1:.3f}, {c2:.3f} ms [{card}]")
    m = cuda_ms(lambda: batch.align_sequences_multi(I, D, TUM_FR1, cfg_an), 3)
    print(f"serving align_sequences_multi: {m:.3f} ms for {T - 1} time steps, {m / (T - 1):.3f} ms a step "
          f"({1e3 * n_pairs / m:.1f} pairs/s) [{card}]")

    rec = {}
    # K-GN shared vs replicated on one tracked chunk: keyframe frame 0,
    # frames 1..KF_CHUNK its targets, the analytic preset (early exit)
    kfI = torch.from_numpy(frames[0].intensity).to(dev)
    kfD = torch.from_numpy(frames[0].depth).to(dev).to(torch.float32) * float(np.float32(DEPTH_SCALE))
    chunk = torch.from_numpy(np.stack([f.intensity for f in frames[1:KF_CHUNK + 1]])).to(dev)
    kf_prep = prep_keyframe(kfI, kfD, TUM_FR1, cfg_an)
    tgt = prep_frame_targets(analytic.device_unit_intensity(chunk), cfg_an)
    n_bytes = flops = 0.0
    args, rep = {}, {}
    for level in sorted(kf_prep, reverse=True):
        H, W = level_shape(SHAPE, level)
        i0, geom = kf_prep[level]
        init = torch.zeros((KF_CHUNK, 6), device=dev)
        args[level] = ((i0, geom, tgt[level], TUM_FR1.at_level(level), init, *analytic._gn_options(cfg_an, level)),
                       dict(H=H, W=W, sampling=cfg_an.sampling))
        rep[level] = (*replicated(i0, geom, tgt[level]), *args[level][0][2:])
        res = fb.fused_gn_level_batch(*args[level][0], **args[level][1])
        n_bytes += nbytes(i0, geom, tgt[level], init, *res)
        flops += float(res.iterations.double().sum()) * H * W * GN_FLOPS[cfg_an.sampling]
    t = timed_levels(
        "K-GN shared", [(lv, f"level {lv} {level_shape(SHAPE, lv)} {KF_CHUNK} targets of one keyframe, the analytic "
                             f"preset; beside it K-GN replicated") for lv in sorted(kf_prep, reverse=True)],
        lambda lv: fb.fused_gn_level_batch(*args[lv][0], **args[lv][1]),
        lambda lv: fb.fused_gn_level_batch_reference(*args[lv][0], **args[lv][1]),
        lambda lv: fb.fused_gn_level_batch(*rep[lv], **args[lv][1]),
        card,
    )
    rec["fused_gn_level_batch_shared"] = dict(ms=t["ms"], plain_ms=t["plain_ms"], replicated_ms=t["other_ms"])
    rec["fused_gn_level_batch_shared"]["bound_ms"], rec["fused_gn_level_batch_shared"]["bound_by"] = bound(n_bytes, flops)

    # K-TR shared: the ceres preset's five levels, chained as the tracker
    # chains them (each level from the kernel's states of the level before)
    kf_tr = prep_keyframe(kfI, kfD, TUM_FR1, cfg_tr)
    tgt_tr = prep_frame_targets(analytic.device_unit_intensity(chunk), cfg_tr)
    n_bytes = flops = 0.0
    init = torch.zeros((KF_CHUNK, 6), device=dev)
    args = {}
    for level in sorted(kf_tr, reverse=True):
        H, W = level_shape(SHAPE, level)
        i0, geom = kf_tr[level]
        args[level] = (i0, geom, tgt_tr[level], TUM_FR1.at_level(level), init, cfg_tr.trust_region_options(level))
        res = fb.fused_tr_level_batch(*args[level], H=H, W=W)
        n_bytes += nbytes(i0, geom, tgt_tr[level], init, *res)
        flops += float(KF_CHUNK + res.iterations.double().sum()) * H * W * GN_FLOPS["bilinear"]
        init = res.state
    t = timed_levels(
        "K-TR shared", [(lv, f"level {lv} {level_shape(SHAPE, lv)} {KF_CHUNK} targets of one keyframe, the ceres preset")
                        for lv in sorted(kf_tr, reverse=True)],
        lambda lv: fb.fused_tr_level_batch(*args[lv], H=level_shape(SHAPE, lv)[0], W=level_shape(SHAPE, lv)[1]),
        lambda lv: fb.fused_tr_level_batch_reference(*args[lv], H=level_shape(SHAPE, lv)[0],
                                                     W=level_shape(SHAPE, lv)[1]),
        card=card,
    )
    rec["fused_tr_level_batch_shared"] = dict(ms=t["ms"], plain_ms=t["plain_ms"])
    rec["fused_tr_level_batch_shared"]["bound_ms"], rec["fused_tr_level_batch_shared"]["bound_by"] = bound(n_bytes, flops)

    # fused_gn_level_multi at S = 8: the serving step's first time step.
    # The kernel's time is fused_gn_level_multi_packs on packs built once
    # (as align_batch_fused calls it); the packing wrapper
    # fused_gn_level_multi, which packs the geometry on every call, is
    # timed beside it.
    L, scales = cfg_an.num_levels, cfg_an.gradient_scales
    fI = analytic.device_unit_intensity(I[:, 0]).to(torch.float32)
    tI = analytic.device_unit_intensity(I[:, 1]).to(torch.float32)
    int0, dep0, int1 = pyr.build_pyramid(fI, L), pyr.build_pyramid(D[:, 0], L), pyr.build_pyramid(tI, L)
    gx1, gy1 = pyr.build_gradient_pyramid(int1, scales)
    n_bytes = flops = 0.0
    args, packs = {}, {}
    for level in sorted(kf_prep, reverse=True):
        H, W = level_shape(SHAPE, level)
        init = torch.zeros((S, 6), device=dev)
        args[level] = (int0[level], dep0[level], torch.cat([int1[level], gx1[level], gy1[level]], -2),
                       TUM_FR1.at_level(level), init, cfg_an.min_depth, cfg_an.max_depth,
                       *analytic._gn_options(cfg_an, level), cfg_an.sampling)
        packs[level] = (*fused_ops._multi_packs(*args[level][:5], cfg_an.min_depth, cfg_an.max_depth, None),
                        *analytic._gn_options(cfg_an, level))
        res = fused_ops.fused_gn_level_multi_packs(*packs[level][:3], TUM_FR1.at_level(level), *packs[level][3:],
                                                   H=H, W=W, sampling=cfg_an.sampling)
        # the packs it reads and the results it writes
        n_bytes += nbytes(*packs[level][:4], *res)
        flops += float(res.iterations.double().sum()) * H * W * GN_FLOPS[cfg_an.sampling]
    t = timed_levels(
        "multi-stream level (B7 on K-GN)",
        [(lv, f"level {lv} {level_shape(SHAPE, lv)} S = {S} on prebuilt packs, the analytic preset; beside it the "
              f"packing wrapper fused_gn_level_multi") for lv in sorted(kf_prep, reverse=True)],
        lambda lv: fused_ops.fused_gn_level_multi_packs(*packs[lv][:3], TUM_FR1.at_level(lv), *packs[lv][3:],
                                                        H=level_shape(SHAPE, lv)[0], W=level_shape(SHAPE, lv)[1],
                                                        sampling=cfg_an.sampling),
        lambda lv: fused_ops.fused_gn_level_multi_reference(*args[lv]),
        lambda lv: fused_ops.fused_gn_level_multi(*args[lv]),
        card=card,
    )
    rec["fused_gn_level_multi"] = dict(ms=t["ms"], plain_ms=t["plain_ms"], packing_wrapper_ms=t["other_ms"])
    rec["fused_gn_level_multi"]["bound_ms"], rec["fused_gn_level_multi"]["bound_by"] = bound(n_bytes, flops)
    for name, r in rec.items():
        print(f"{name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})"
              + (f", K-GN replicated {r['replicated_ms']:.4f} ms" if "replicated_ms" in r else "")
              + (f", packing wrapper {r['packing_wrapper_ms']:.4f} ms" if "packing_wrapper_ms" in r else "")
              + f" [{card}]")
    return rec


# Phase 7f: the cluster layout of K-TR and K-GN, and phase 7c's of K-IC
# and K-ICpre. The C entry of each, and the source that declares it.
LEVEL_ENTRIES = {"tr": ("fused_tr_batch.cu", "phovo_fused_tr_level_batch"),
                 "gn": ("fused_gn_batch.cu", "phovo_fused_gn_level_batch"),
                 "lin": ("fused_lin.cu", "phovo_fused_lin"),
                 "ic": ("ic_gn_batch.cu", "phovo_ic_gn_level_batch"),
                 "icpre": ("ic_precompute.cu", "phovo_ic_precompute")}


def entry_names(kind: str) -> list:
    """The parameter names of this tree's C entry of a kernel ('tr', 'gn',
    'lin', 'ic' or 'icpre'), from its `extern "C"` signature."""
    from phovo_tpu_torch.ops import _build

    source, name = LEVEL_ENTRIES[kind]
    return [n for n, _ in _build.entry_signatures((_build.CSRC / source).read_text())[name]]


def entry_launcher(fn, names, kind, args, kw, cluster=None, **force):
    """(run, out, diag): run() launches a kernel's C entry fn, whose
    parameters are `names` (another tree's entry may lack some of this
    tree's, such as `cluster`), once on a wrapper call's inputs (args and
    kw of fused_tr_level_batch for 'tr', fused_gn_level_batch for 'gn',
    fused_lin_batch for 'lin', ic_gn_level_batch for 'ic',
    ic_precompute_batch for 'icpre') with `cluster` blocks a pair (default:
    the rule's; K-LIN's split G) and `force` (K-IC's `resident`). out and diag are the buffers it writes: the states (K-IC:
    the pose rows) and the diagnostics, whose column 0 is the iteration
    count; for 'icpre' the factors L and the rows J8; for 'lin' the Grams
    and the scratch of the partial sums. Such launches are not counted; a
    refused one raises."""
    from phovo_tpu_torch.ops import fused_batch as fb
    from phovo_tpu_torch.ops import ic as IC
    from phovo_tpu_torch.ops import ic_batch as ICB

    stream = torch.cuda.current_stream().cuda_stream
    if kind == "ic":
        values, buffers = ICB._ic_launch_args(args[0].to(torch.float32).contiguous(), *args[1:], **kw,
                                              stream=stream, cluster=cluster, **force)
        outs = buffers[1:]
    elif kind == "icpre":
        values, buffers = IC._ic_precompute_launch_args(*args, **kw, stream=stream, cluster=cluster)
        outs = buffers[::-1]
    elif kind == "lin":
        values, buffers = fb._lin_launch_args(*args, **kw, stream=stream, split=cluster, **force)
        outs = buffers
    else:
        make = fb._tr_launch_args if kind == "tr" else fb._gn_launch_args
        values, buffers = make(*args, **kw, stream=stream, cluster=cluster)
        outs = buffers
    named = dict(zip(entry_names(kind), values))
    call = [named[n] for n in names]

    def run():
        assert buffers  # every buffer the call points at lives as long as run
        err = fn(*call)
        if err:
            raise RuntimeError(f"{LEVEL_ENTRIES[kind][1]} failed: CUDA error {err} (cluster {cluster}, {force})")

    return run, outs[0], outs[1]


def cluster_workloads(dev, frames):
    """[(group, label, kind, wrapper args, wrapper kw)]: the level launches
    whose layout the cluster rule sets, on the timing workloads' frames
    (make_pair alternated; the keyframe loop's first 17 frames):
      * K-TR at B = 1: one pair's 480x640 level of the ceres preset, from
        zero (the B5 row);
      * K-GN and K-GN-bi at B = 1: one pair's 480x640 level, 3 nearest
        iterations (the B3 and B4 rows);
      * K-TR shared: KF_CHUNK targets of one keyframe, the ceres preset's
        five levels chained from zero (the B2-shared row);
      * K-GN shared: the same targets, the analytic preset's three levels;
      * the ceres chain: 256 pairs, K-TR's five levels chained from zero;
      * the bench chain: 256 pairs, K-GN and K-GN-bi at 120x160, 60x80 and
        30x40 with 5, 20 and 50 nearest iterations.
    Chained levels start from the kernel's states of the level before."""
    from phovo_tpu_torch.models import analytic, biobjective
    from phovo_tpu_torch.models.analytic import prep_frame_analytic, prep_frame_targets, prep_keyframe
    from phovo_tpu_torch.ops import fused_batch as fb
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.ops.pyramid import level_shape
    from phovo_tpu_torch.utils.config import config_from_dict

    cfg_tr, cfg_an = config_from_dict(CERES_PRESET), config_from_dict(ANALYTIC_PRESET)
    cfg0, cfg_fixed = config_from_dict(LEVEL0_PRESET), bench_config(0.0)
    Is, Ds = timing_frames(dev)
    n_pairs = N_FRAMES - 1
    cases = []

    def tr_chain(group, packs, n):
        init = torch.zeros((n, 6), device=dev)
        for level in sorted(packs, reverse=True):
            H, W = level_shape(SHAPE, level)
            args = (*packs[level], TUM_FR1.at_level(level), init, cfg_tr.trust_region_options(level))
            cases.append((group, f"level {level} {H}x{W}", "tr", args, dict(H=H, W=W)))
            init = fb.fused_tr_level_batch(*args, H=H, W=W).state

    one = pair_packs(prep_frame_analytic(Is[:2], Ds[:2], TUM_FR1, cfg_tr))[0]
    z1 = torch.zeros((1, 6), device=dev)
    full = dict(H=SHAPE[0], W=SHAPE[1])
    label = f"level 0 {SHAPE[0]}x{SHAPE[1]}"
    cases.append(("K-TR B = 1", label, "tr", (*one, TUM_FR1, z1, cfg_tr.trust_region_options(0)), full))
    gn1 = (*one, TUM_FR1, z1, NEAREST_ITERATIONS, 0.0, 1.0)
    cases.append(("K-GN B = 1", label, "gn", gn1, dict(full, sampling="nearest")))
    bi1 = pair_packs(biobjective.prep_frame_biobjective(Is[:2], Ds[:2], TUM_FR1, cfg0))[0]
    cases.append(("K-GN-bi B = 1", label, "gn", (*bi1[:3], *gn1[3:]), dict(full, sampling="nearest", depth_gains=bi1[3])))

    kfI = torch.from_numpy(frames[0].intensity).to(dev)
    kfD = torch.from_numpy(frames[0].depth).to(dev).to(torch.float32) * float(np.float32(DEPTH_SCALE))
    chunk = analytic.device_unit_intensity(torch.from_numpy(np.stack([f.intensity for f in frames[1:KF_CHUNK + 1]])).to(dev))
    kf, tgt = prep_keyframe(kfI, kfD, TUM_FR1, cfg_tr), prep_frame_targets(chunk, cfg_tr)
    tr_chain(f"K-TR shared ({KF_CHUNK} targets)", {lv: (*kf[lv], tgt[lv]) for lv in kf}, KF_CHUNK)
    kf, tgt = prep_keyframe(kfI, kfD, TUM_FR1, cfg_an), prep_frame_targets(chunk, cfg_an)
    for level in sorted(kf, reverse=True):
        H, W = level_shape(SHAPE, level)
        args = (*kf[level], tgt[level], TUM_FR1.at_level(level), torch.zeros((KF_CHUNK, 6), device=dev),
                *analytic._gn_options(cfg_an, level))
        cases.append((f"K-GN shared ({KF_CHUNK} targets)", f"level {level} {H}x{W}", "gn", args,
                      dict(H=H, W=W, sampling=cfg_an.sampling)))

    tr_chain(f"ceres chain ({n_pairs} pairs)", pair_packs(prep_frame_analytic(Is, Ds, TUM_FR1, cfg_tr)), n_pairs)
    z = torch.zeros((n_pairs, 6), device=dev)
    for group, prep in ((f"bench chain K-GN ({n_pairs} pairs)", prep_frame_analytic),
                        (f"bench chain K-GN-bi ({n_pairs} pairs)", biobjective.prep_frame_biobjective)):
        packs = pair_packs(prep(Is, Ds, TUM_FR1, cfg_fixed))
        for level in sorted((lv for lv, n in enumerate(cfg_fixed.max_iterations) if n > 0), reverse=True):
            H, W = level_shape(SHAPE, level)
            i0, geom, t_all, *gains = packs[level]
            kw = dict(H=H, W=W, sampling="nearest", **({"depth_gains": gains[0]} if gains else {}))
            cases.append((group, f"level {level} {H}x{W}", "gn",
                          (i0, geom, t_all, TUM_FR1.at_level(level), z, cfg_fixed.max_iterations[level], 0.0, 1.0),
                          kw))
    return cases


LIN_BATCHES = (1, 16, 256)


def lin_workloads(dev, batches=LIN_BATCHES, samplings=("nearest", "bilinear")):
    """[(group, label, 'lin', fused_lin_batch args, kw)]: one linearization
    (K-LIN) of the first B pairs of the timing workloads' frames at every
    VGA level, at seeded small states (compare_lin's), per sampling."""
    from phovo_tpu_torch.models.analytic import prep_frame_analytic
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.ops.pyramid import level_shape
    from phovo_tpu_torch.utils.config import config_from_dict

    cfg = config_from_dict(dict(ANALYTIC_PRESET, max_iterations=[3] * 5))
    Is, Ds = timing_frames(dev)
    n = max(batches) + 1
    packs = pair_packs(prep_frame_analytic(Is[:n], Ds[:n], TUM_FR1, cfg))
    del Is, Ds
    cases = []
    for B in batches:
        for level in range(5):
            H, W = level_shape(SHAPE, level)
            i0, geom, t_all = (x[:B].contiguous() for x in packs[level])
            g = torch.Generator().manual_seed(level)
            states = (torch.randn((B, 6), generator=g) * 1e-3).to(dev)
            for sampling in samplings:
                cases.append((f"K-LIN B = {B} {sampling}", f"level {level} {H}x{W}", "lin",
                              (i0, geom, t_all, TUM_FR1.at_level(level), states), dict(H=H, W=W, sampling=sampling)))
    return cases


def lin_case_work(args, kw, gram) -> tuple[int, float]:
    """(bytes, float32 operations) of one K-LIN launch on fused_lin_batch's
    args and kw with its Grams: each input read once, the Grams written
    once; a pass over every pixel of every pair."""
    i0, geom, t_all, _, states = args[:5]
    ops = i0.shape[0] * kw["H"] * kw["W"] * (GN_FLOPS[kw.get("sampling", "nearest")] + LIN_EXTRA_FLOPS)
    return nbytes(i0, geom, t_all, states, gram) + 4 * i0.shape[0], float(ops)


def level_clusters(levels, rule=None) -> dict:
    """{'HxW': the rule's blocks a pair} of pyramid levels of SHAPE; rule
    defaults to K-GN's and K-TR's, fused_batch.cluster_size."""
    from phovo_tpu_torch.ops.fused_batch import cluster_size
    from phovo_tpu_torch.ops.pyramid import level_shape

    rule = rule or cluster_size
    return {"x".join(map(str, level_shape(SHAPE, lv))): rule(*level_shape(SHAPE, lv)) for lv in levels}


# Phase 4f: the CLIs on a synthetic VGA sequence in the raw layout
CLI_FRAMES = 33
CLI_CHUNK = 16
CLI_FRAME_MODE_PAIRS = 7
CLI_SERVE_FRAMES = (CLI_FRAMES, 17)  # the two served streams' lengths
CLI_ONE_FRAME_STREAMS, CLI_ONE_FRAME_LEN = 3, 9  # phovo-serve --chunk 1: streams and frames a stream
CLI_PRESETS = {"analytic": "config_5_level_optimization_analytic", "ceres": "config_5_level_optimization_ceres",
               "ic": "config_5_level_optimization_analytic", "biobjective": "config_5_level_optimization_analytic"}


def write_raw_sequence(out, I8, D16, ts, depth_scale):
    """A sequence in datasets/raw.py's layout (version 2), as phovo-convert
    writes it: uint8 intensity, uint16 depth counts, timestamps."""
    import pathlib

    from phovo_tpu_torch.datasets import raw

    out = pathlib.Path(out)
    out.mkdir(parents=True)
    np.save(out / "intensity.u8.npy", I8)
    np.save(out / "depth.u16.npy", D16)
    np.save(out / "timestamps.f64.npy", np.asarray(ts, np.float64))
    np.save(out / "depth_timestamps.f64.npy", np.asarray(ts, np.float64))
    meta = {"format_version": raw.FORMAT_VERSION, "n": len(I8), "height": int(I8.shape[1]),
            "width": int(I8.shape[2]), "depth_scale": float(depth_scale), "pairing": "associate",
            "source": "chip_smoke synthetic"}
    (out / raw.META_NAME).write_text(json.dumps(meta))
    return out


def chunk_entries() -> dict:
    """{backend: (its align_sequence_chunk* entry, the entry's
    backend-specific argument)}, named here rather than taken from the
    CLI, so that the in-process chain checks the CLI's dispatch."""
    from phovo_tpu_torch.models.analytic import align_sequence_chunk
    from phovo_tpu_torch.models.autodiff import align_sequence_chunk_autodiff
    from phovo_tpu_torch.models.biobjective import align_sequence_chunk_biobjective
    from phovo_tpu_torch.models.ic import align_sequence_chunk_ic

    return {"analytic": (align_sequence_chunk, True), "ceres": (align_sequence_chunk_autodiff, "linearizer"),
            "autodiff": (align_sequence_chunk_autodiff, "linearizer"), "ic": (align_sequence_chunk_ic, True),
            "biobjective": (align_sequence_chunk_biobjective, True)}


def chunk_chain_lines(backend, I8, D16, ts, cfg, intr, dev, chunk):
    """The trajectory lines phovo-vo --chunk writes, computed in process:
    the backend's align_sequence_chunk* entry (chunk_entries) over the same
    chunks of the same frames (uint8 and uint16 on the device, the carry
    frame kept there), the poses integrated on the host. Returns the
    lines."""
    from phovo_tpu_torch.ops import se3
    from phovo_tpu_torch.utils.trajectory import format_pose_line

    fn, arg = chunk_entries()[backend]
    carry_i = torch.from_numpy(I8[0]).to(dev)
    carry_d = torch.from_numpy(D16[0]).to(dev).to(torch.float32) * float(np.float32(DEPTH_SCALE))
    pose, lines = np.eye(4), []
    for lo in range(1, len(I8), chunk):
        hi = min(lo + chunk, len(I8))
        res, carry_i, carry_d = fn(carry_i, carry_d, torch.from_numpy(I8[lo:hi]).to(dev),
                                   torch.from_numpy(D16[lo:hi]).to(dev), intr, cfg, arg, False, DEPTH_SCALE)
        for k, state in enumerate(res.state.cpu().numpy()):
            pose = pose @ np.linalg.inv(se3.pose_matrix_np(state))
            lines.append(format_pose_line(ts[lo + k], pose))
    return lines


def pose_lines(path) -> list:
    """A trajectory file's pose lines (its header dropped)."""
    return [ln for ln in open(path).read().splitlines() if ln.strip() and not ln.startswith("#")]


def phase_cli(fb, dev, card, shape=SHAPE):
    """Phase 4f: the port's CLIs in process (main(argv)) on CLI_FRAMES
    synthetic frames written in the raw layout with their ground truth,
    every preset read by the port's reader: phovo-vo --chunk CLI_CHUNK for
    analytic, ceres, ic and biobjective (each trajectory the in-process
    chunked chain's lines, bit for bit), frame mode over
    CLI_FRAME_MODE_PAIRS pairs, --mode keyframe (analytic), phovo-serve
    with two streams (each the lines of its own phovo-vo --chunk run),
    phovo-serve --chunk 1 with three (one new frame a stream a round, each
    the lines of its own phovo-vo --chunk 1 run) and
    phovo-eval --json (each ATE below standing still). Each run's launches
    are counted from 0 and checked. Returns {CLI run: launches}."""
    import contextlib
    import io
    import pathlib
    import tempfile

    from phovo_tpu_torch.apps import phovo_eval, phovo_serve, phovo_vo
    from phovo_tpu_torch.datasets import native_loader
    from phovo_tpu_torch.ops import _build
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.utils import config as C
    from phovo_tpu_torch.utils.synthetic import make_sequence
    from phovo_tpu_torch.utils.trajectory import (Trajectory, TrajectoryWriter, absolute_trajectory_error,
                                                   read_trajectory)

    presets = sorted(C.builtin_config_dir().glob("*.yml"))
    cfgs = {p.stem: C.load_config(p) for p in presets}
    print(f"CLI: {len(cfgs)} presets read by the port's reader (no pyyaml): "
          + ", ".join(f"{k} {c.num_levels} levels" for k, c in cfgs.items()))
    check(len(cfgs) == 12, f"{len(cfgs)} presets, expected 12")
    print(f"CLI: native_loader.available() = {native_loader.available()} (information; the phase reads the raw "
          f"layout)")
    device = "cpu" if dev.type == "cpu" else "cuda"
    intr = TUM_FR1 if shape == SHAPE else TUM_FR1.at_level(int(np.log2(SHAPE[0] // shape[0])))
    spec = ",".join(repr(float(v)) for v in intr)
    I, D, gts, ts = make_sequence(intr, shape, CLI_FRAMES)
    I8 = np.round(np.stack(I) * 255.0).astype(np.uint8)
    D16 = np.round(np.stack(D) / DEPTH_SCALE).astype(np.uint16)
    launches = {}

    def counted(name, run):
        reset_counts(fb)
        t0 = time.perf_counter()
        rc = run()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(rc == 0, f"{name} exited with {rc}")
        launches[name] = launch_counts(fb)
        return wall

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        tmp = pathlib.Path(tmp)
        seq = write_raw_sequence(tmp / "seq", I8, D16, ts, DEPTH_SCALE)
        gt_path = tmp / "groundtruth.txt"
        with TrajectoryWriter(gt_path) as w:
            for t, g in zip(ts, gts):
                w.write(t, g)
        gt = read_trajectory(gt_path)
        common = ["--dataset", str(seq), "--intrinsics", spec, "--device", device, "-q"]

        def ate_of(path):
            est = read_trajectory(path)
            still = Trajectory(est.timestamps, np.zeros_like(est.positions),
                               np.tile([0.0, 0.0, 0.0, 1.0], (len(est), 1)))
            return absolute_trajectory_error(est, gt)["rmse"], absolute_trajectory_error(still, gt)["rmse"]

        n_pairs = CLI_FRAMES - 1
        for backend, preset in CLI_PRESETS.items():
            out = tmp / f"vo_{backend}.txt"
            cfg_path = C.builtin_config_dir() / f"{preset}.yml"
            wall = counted(f"phovo-vo --chunk {CLI_CHUNK} {backend}", lambda: phovo_vo.main(
                ["--config", str(cfg_path), "--output", str(out), "--backend", backend, "--chunk", str(CLI_CHUNK),
                 "--loader", "raw", *common]))
            ref = chunk_chain_lines(backend, I8, D16, ts, cfgs[preset], intr, dev, CLI_CHUNK)
            same = pose_lines(out) == ref
            ate, still = ate_of(out)
            print(f"CLI phovo-vo --chunk {CLI_CHUNK} --backend {backend} ({preset}): {n_pairs} pairs in {wall:.3f} s, "
                  f"{n_pairs / wall:.1f} pairs/s; the in-process chunked chain's lines {same}; ATE {ate:.6f} m "
                  f"(standing still {still:.6f}); launches {launches[f'phovo-vo --chunk {CLI_CHUNK} {backend}']} "
                  f"[{card}]")
            check(same, f"phovo-vo --chunk {backend} differs from the in-process chain")
            check(np.isfinite(ate) and ate < still, f"phovo-vo --chunk {backend} ATE {ate} not below {still}")
        n_chunks = -(-n_pairs // CLI_CHUNK)
        active = sum(1 for n in cfgs[CLI_PRESETS["analytic"]].max_iterations if n > 0)
        tr_active = sum(1 for n in cfgs[CLI_PRESETS["ceres"]].max_iterations if n > 0)
        got = launches[f"phovo-vo --chunk {CLI_CHUNK} analytic"]
        check(got["K-GN"] == active * n_chunks and got["K-GN-bi"] == 0 and got["K-TR"] == 0,
              f"analytic CLI launches {got}")
        got = launches[f"phovo-vo --chunk {CLI_CHUNK} ceres"]
        check(got["K-TR"] == tr_active * n_chunks and got["K-GN"] == 0, f"ceres CLI launches {got}")
        got = launches[f"phovo-vo --chunk {CLI_CHUNK} ic"]
        check(got["K-IC"] == active * n_chunks and got["K-ICpre"] > 0 and got["K-GN"] == 0, f"ic CLI launches {got}")
        got = launches[f"phovo-vo --chunk {CLI_CHUNK} biobjective"]
        check(got["K-GN"] == got["K-GN-bi"] == active * n_chunks and got["K-TR"] == 0,
              f"biobjective CLI launches {got}")
        # the same preset: the depth term must move the trajectory
        check(pose_lines(tmp / "vo_biobjective.txt") != pose_lines(tmp / "vo_analytic.txt"),
              "phovo-vo --chunk biobjective wrote the analytic trajectory")

        cfg_path = str(C.builtin_config_dir() / f"{CLI_PRESETS['analytic']}.yml")
        out = tmp / "vo_frame.txt"
        wall = counted("phovo-vo frame mode", lambda: phovo_vo.main(
            ["--config", cfg_path, "--output", str(out), "--max-frames", str(CLI_FRAME_MODE_PAIRS), "--loader", "raw",
             *common]))
        got = launches["phovo-vo frame mode"]
        frame_lines = pose_lines(out)
        err = float(np.abs(read_trajectory(out).positions - np.asarray(
            [[float(v) for v in ln.split()[1:4]] for ln in pose_lines(tmp / "vo_analytic.txt")[:len(frame_lines)]]
        )).max())
        print(f"CLI phovo-vo frame mode: {CLI_FRAME_MODE_PAIRS} pairs in {wall:.3f} s, "
              f"{CLI_FRAME_MODE_PAIRS / wall:.1f} pairs/s; max|position - the chunked run's| {err:.3e} m; launches "
              f"{got} [{card}]")
        check(len(frame_lines) == CLI_FRAME_MODE_PAIRS and got["K-GN"] == active * CLI_FRAME_MODE_PAIRS,
              f"frame mode wrote {len(frame_lines)} poses with launches {got}")
        check(err <= 1e-4, f"frame mode vs chunked positions {err}")

        launches.update(phase_cli_diffs(fb, dev, card, I8, D16, seq, intr, spec, tmp))

        out = tmp / "vo_keyframe.txt"
        wall = counted("phovo-vo --mode keyframe", lambda: phovo_vo.main(
            ["--config", cfg_path, "--output", str(out), "--mode", "keyframe", "--chunk", str(CLI_CHUNK),
             "--loader", "raw", *common]))
        got = launches["phovo-vo --mode keyframe"]
        ate, still = ate_of(out)
        print(f"CLI phovo-vo --mode keyframe --chunk {CLI_CHUNK}: {CLI_FRAMES} frames in {wall:.3f} s, "
              f"{CLI_FRAMES / wall:.1f} frames/s; ATE {ate:.6f} m (standing still {still:.6f}); launches {got} [{card}]")
        check(len(pose_lines(out)) == CLI_FRAMES - 1 and got["K-GN shared"] > 0, f"keyframe CLI launches {got}")
        check(np.isfinite(ate) and ate < still, f"keyframe CLI ATE {ate} not below {still}")

        streams = []
        for k, n in enumerate(CLI_SERVE_FRAMES):
            d = write_raw_sequence(tmp / f"stream{k}", I8[:n], D16[:n], ts[:n], DEPTH_SCALE)
            single = tmp / f"single{k}.txt"
            check(phovo_vo.main(["--config", cfg_path, "--output", str(single), "--chunk", str(CLI_CHUNK),
                                 "--dataset", str(d), "--intrinsics", spec, "--device", device, "-q"]) == 0,
                  "single-stream phovo-vo failed")
            streams.append((d, single))
        served = tmp / "served"
        wall = counted("phovo-serve", lambda: phovo_serve.main(
            ["--config", cfg_path, *[a for d, _ in streams for a in ("--dataset", str(d))], "--out-dir", str(served),
             "--chunk", str(CLI_CHUNK), "--intrinsics", spec, "--device", device, "-q"]))
        got = launches["phovo-serve"]
        same = [pose_lines(served / f"{d.name}.txt") == pose_lines(single) for d, single in streams]
        served_pairs = sum(n - 1 for n in CLI_SERVE_FRAMES)
        print(f"CLI phovo-serve, {len(streams)} streams ({served_pairs} pairs) in {wall:.3f} s, "
              f"{served_pairs / wall:.1f} pairs/s; each stream its own phovo-vo --chunk lines {same}; launches {got} "
              f"[{card}]")
        check(all(same), "a served stream differs from its single-stream phovo-vo trajectory")
        check(got["K-GN"] == active * n_chunks, f"phovo-serve launches {got}")

        # live cameras: one new frame a stream a round (--chunk 1), each stream
        # from its own start in the sequence
        ones = []
        for k in range(CLI_ONE_FRAME_STREAMS):
            sl = slice(3 * k, 3 * k + CLI_ONE_FRAME_LEN)
            d = write_raw_sequence(tmp / f"live{k}", I8[sl], D16[sl], ts[sl], DEPTH_SCALE)
            single = tmp / f"live_single{k}.txt"
            check(phovo_vo.main(["--config", cfg_path, "--output", str(single), "--chunk", "1", "--dataset", str(d),
                                 "--intrinsics", spec, "--device", device, "-q"]) == 0,
                  "single-stream phovo-vo --chunk 1 failed")
            ones.append((d, single))
        served = tmp / "served_live"
        wall = counted("phovo-serve --chunk 1", lambda: phovo_serve.main(
            ["--config", cfg_path, *[a for d, _ in ones for a in ("--dataset", str(d))], "--out-dir", str(served),
             "--chunk", "1", "--intrinsics", spec, "--device", device, "-q"]))
        got = launches["phovo-serve --chunk 1"]
        same = [pose_lines(served / f"{d.name}.txt") == pose_lines(single) for d, single in ones]
        rounds = CLI_ONE_FRAME_LEN - 1
        print(f"CLI phovo-serve --chunk 1, {len(ones)} streams, {rounds} rounds in {wall:.3f} s; each stream its "
              f"own phovo-vo --chunk 1 lines {same}; launches {got} [{card}]")
        check(all(same), "a stream served one frame a round differs from its single-stream phovo-vo trajectory")
        check(got["K-GN"] == active * rounds, f"phovo-serve --chunk 1 launches {got}")

        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = phovo_eval.main([str(gt_path), str(tmp / "vo_analytic.txt"), "--json"])
        wall = time.perf_counter() - t0
        result = json.loads(buf.getvalue())
        ate, still = ate_of(tmp / "vo_analytic.txt")
        print(f"CLI phovo-eval --json: {wall:.3f} s; ATE rmse {result['ate']['rmse']:.6f} m over "
              f"{result['ate']['num_pairs']} poses, RPE {result['rpe']['trans_rmse']:.6f} m / "
              f"{result['rpe']['rot_rmse_deg']:.4f} deg [{card}]")
        check(rc == 0 and result["ate"]["rmse"] == ate and ate < still, f"phovo-eval gave {result}")
    return launches


# the keyframe back-end (phases 4g and 7g): 48 VGA frames of the room
# along its forward sweep through phovo-vo --mode keyframe --chunk 16 and
# the analytic preset, without bundle adjustment, with BA_ITERATIONS
# windowed and with BA_ITERATIONS global (and the map)
BA_FRAMES = 48
BA_ITERATIONS = 3
BA_PRESET = "config_5_level_optimization_analytic"
BA_RUNS = {"pose graph only": [], "BA window": ["--ba-iterations", str(BA_ITERATIONS)],
           "BA global": ["--ba-iterations", str(BA_ITERATIONS), "--ba-scope", "global", "--export-map", "map.ply"]}
# the back-end on the card against the same back-end on the CPU, from the
# same keyframes, at damping 1.0 (at the production 1e-4 one LM step
# amplifies last-ulp differences about 1e4-fold, ARCHITECTURE.md): keyframe
# poses within this. Even at 1.0 the refinement of these VGA keyframes
# answers float32 noise in its start: on the CPU, starting states moved by
# 2e-7 relative move the refined poses by up to 5.0e-6 (window) and 1.2e-5
# (global); the card against the CPU, 3.3e-6 and 1.8e-5 (an H100 80GB HBM3, 700 W)
BA_CPU_ATOL = 5e-5
# phase 7g: one global problem over 64 room keyframes (grid 8, covis 6:
# P = 4,096 landmarks, K = 24,576 observations), and the map-scale
# reprojection problem of tools/ba_scale_bench.py (128 poses, 50,000
# landmarks, 800 observations a pose, 5 LM iterations)
BA_GLOBAL_KF = 64
# that problem at damping 1.0, dense against sparse on the card (the same
# blocks; only the Schur complement's sums differ): states within this.
# tests/test_torch_global_ba_scale.py's CPU readings on the same counts at
# 120x160 and 240x320: 6.0e-8 after one iteration, 1.2e-7 after three
BA_SCHUR_ATOL = 1e-5
BA_MAP_SCALE = dict(n_poses=128, n_points=50_000, obs_per_pose=800, state_noise=0.01, point_noise=0.01, seed=0)
BA_MAP_ITERATIONS = 5


def render_room_frames(intr, shape, poses_cw):
    """render_room at each camera pose, on the host's cores (numpy releases
    the GIL in its array loops): (intensities, depths), the frames of
    make_room_sequence along the same poses."""
    from concurrent.futures import ThreadPoolExecutor

    from phovo_tpu_torch.utils.synthetic import render_room

    with ThreadPoolExecutor(max_workers=8) as pool:
        frames = list(pool.map(lambda T: render_room(intr, shape, T), poses_cw))
    return [f[0] for f in frames], [f[1] for f in frames]


def backend_tracker(cfg, intr, dev):
    """phovo-vo's keyframe tracker with its defaults, on dev."""
    from phovo_tpu_torch.models.analytic import PhotoconsistencyOdometryAnalytic
    from phovo_tpu_torch.models.keyframe import KeyframeVisualOdometry

    vo = PhotoconsistencyOdometryAnalytic(cfg, device=dev)
    vo.set_intrinsic_matrix([[intr.fx, 0, intr.cx], [0, intr.fy, intr.cy], [0, 0, 1]])
    return KeyframeVisualOdometry(vo)


def keyframe_copy(kvo, cfg, intr, dev):
    """A tracker on dev holding kvo's keyframes (images and current
    poses), no tracked frame."""
    from phovo_tpu_torch.models.keyframe import Keyframe

    other = backend_tracker(cfg, intr, dev)
    for k in kvo.keyframes:
        other.keyframes.append(Keyframe(index=k.index, frame_index=k.frame_index, timestamp=k.timestamp,
                                        intensity=k.intensity, depth=k.depth, pose=k.pose.copy(), device=dev))
    return other


def finalize_kwargs(argv) -> dict:
    """finalize's keyword arguments for phovo-vo's flags argv."""
    from phovo_tpu_torch.apps import phovo_vo

    a = phovo_vo.build_parser().parse_args(["-c", "c", "-d", "d", "-o", "o", *argv])
    return dict(ba_iterations=a.ba_iterations, ba_window=a.ba_window, ba_grid=a.ba_grid,
                ba_robust_delta=a.ba_robust_delta, ba_scope=a.ba_scope, ba_covis=a.ba_covis,
                ba_occ_gate=a.ba_occlusion_gate, ba_z_robust_delta=a.ba_z_robust_delta)


def phase_backend(fb, traj, dev, card):
    """Phase 4g: the keyframe back-end. BA_FRAMES VGA frames of the room
    (make_room_sequence's forward sweep) in the raw layout through
    phovo-vo --mode keyframe --chunk 16 (the analytic preset) for each of
    BA_RUNS, each run's kernel launches counted from 0. Checks: each
    trajectory the lines of the in-process run_chunked and finalize with
    the same keyword arguments, bit for bit; BA's ATE below the pose graph's
    alone; the PLY's vertex count the map's; the back-end launches no
    kernel (each BA run's counts are the pose-graph run's); the same
    refinement twice gives the same bits; and the refinement on the card
    against the CPU's from the same keyframes at damping 1.0 within
    BA_CPU_ATOL (window, global, and the windows on the sparse Schur path).
    Returns (the in-process trackers by run, their keyframe poses before
    finalize)."""
    import pathlib
    import tempfile

    from phovo_tpu_torch.apps import phovo_vo
    from phovo_tpu_torch.datasets.tum import RGBDFrame
    from phovo_tpu_torch.ops import _build
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.utils import config as C
    from phovo_tpu_torch.utils.synthetic import forward_trajectory
    from phovo_tpu_torch.utils.trajectory import format_pose_line

    t0 = time.perf_counter()
    poses_cw = forward_trajectory(BA_FRAMES)
    I, D = render_room_frames(TUM_FR1, SHAPE, poses_cw)
    gts = [np.linalg.inv(T) for T in poses_cw]
    ts = np.arange(BA_FRAMES, dtype=np.float64) / 30.0
    I8 = np.round(np.stack(I) * 255.0).astype(np.uint8)
    D16 = np.round(np.stack(D) / DEPTH_SCALE).astype(np.uint16)
    print(f"back-end: rendered {BA_FRAMES} {SHAPE[0]}x{SHAPE[1]} room frames in {time.perf_counter() - t0:.1f} s")
    cfg_path = C.builtin_config_dir() / f"{BA_PRESET}.yml"
    cfg = C.load_config(cfg_path)
    device = "cpu" if dev.type == "cpu" else "cuda"
    spec = ",".join(repr(float(v)) for v in TUM_FR1)
    still = pose_ate(traj, [np.eye(4)] * BA_FRAMES, gts)
    trackers, snaps, launches, ates = {}, {}, {}, {}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        tmp = pathlib.Path(tmp)
        seq = write_raw_sequence(tmp / "room", I8, D16, ts, DEPTH_SCALE)
        for name, flags in BA_RUNS.items():
            flags = [str(tmp / f) if f == "map.ply" else f for f in flags]
            out = tmp / "t.txt"
            reset_counts(fb)
            t0 = time.perf_counter()
            rc = phovo_vo.main(["--config", str(cfg_path), "--dataset", str(seq), "--output", str(out), "--intrinsics",
                                spec, "--device", device, "-q", "--mode", "keyframe", "--chunk", str(KF_CHUNK),
                                "--loader", "raw", *flags])
            if dev.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(rc == 0, f"phovo-vo {name} exited with {rc}")
            launches[name] = launch_counts(fb)
            lines = pose_lines(out)
            # the same run in process
            kvo = backend_tracker(cfg, TUM_FR1, dev)
            frames = (RGBDFrame(float(ts[k]), float(ts[k]), I8[k], D16[k]) for k in range(BA_FRAMES))
            list(kvo.run_chunked(frames, chunk=KF_CHUNK, depth_scale=DEPTH_SCALE))
            snaps[name] = [k.pose.copy() for k in kvo.keyframes]
            kw = finalize_kwargs(flags)
            tracked = kvo.finalize(**kw)
            same = lines == [format_pose_line(tf.timestamp, tf.pose) for tf in tracked]
            ates[name] = pose_ate(traj, [np.eye(4)] + [tf.pose for tf in tracked], gts)
            trackers[name] = kvo
            ms = {k: f"{1e3 * v:.3f}" for k, v in kvo.finalize_timings.items()}
            print(f"back-end phovo-vo --mode keyframe {' '.join(flags[:4])}: {BA_FRAMES} frames in {wall:.3f} s; "
                  f"{len(kvo.keyframes)} keyframes, {len(kvo.loop_closures)} loop closures; the in-process "
                  f"run_chunked + finalize lines {same}; ATE {ates[name]:.6f} m (standing still {still:.6f}); "
                  f"finalize ms {ms}; launches {launches[name]} [{card}]")
            check(same, f"phovo-vo {name}: not the in-process finalize's lines")
            check(len(lines) == BA_FRAMES - 1 and np.isfinite(ates[name]) and ates[name] < still,
                  f"phovo-vo {name}: {len(lines)} poses, ATE {ates[name]}")
            others = {k: v for k, v in launches[name].items() if k not in ("K-GN", "K-GN shared")}
            check(launches[name]["K-GN shared"] > 0 and not any(others.values()),
                  f"phovo-vo {name} launches {launches[name]}")
            check(launches[name] == launches["pose graph only"], f"the back-end launched a kernel: {launches}")
            if "--export-map" in flags:
                ply = pathlib.Path(flags[flags.index("--export-map") + 1]).read_text().splitlines()
                n_ply = int([ln for ln in ply if ln.startswith("element vertex")][0].split()[-1])
                print(f"back-end map: {n_ply} PLY vertices, {len(kvo.map_points)} map points")
                check(n_ply == len(kvo.map_points) == len(ply) - ply.index("end_header") - 1 > 0,
                      f"the PLY holds {n_ply} vertices for {len(kvo.map_points)} map points")
    print(f"back-end ATE: pose graph only {ates['pose graph only']:.6f} m, BA({BA_ITERATIONS}) window "
          f"{ates['BA window']:.6f} m, BA({BA_ITERATIONS}) global {ates['BA global']:.6f} m [{card}]")
    check(ates["BA window"] < ates["pose graph only"], "BA did not lower the ATE below the pose graph's")

    # the same refinement twice: the same bits (index_put_ adds in a fixed
    # order); then the card against the CPU from the same keyframes
    for name in ("BA window", "BA global"):
        kvo, kw = trackers[name], finalize_kwargs(BA_RUNS[name][:4])
        first = ([k.pose.copy() for k in kvo.keyframes], kvo.map_points.copy())
        for k, p in zip(kvo.keyframes, snaps[name]):
            k.pose = p.copy()
        kvo.finalize(**kw)
        again = all(np.array_equal(k.pose, p) for k, p in zip(kvo.keyframes, first[0])) and np.array_equal(
            kvo.map_points, first[1])
        print(f"back-end {name}: the same refinement twice gives the same bits {again} [{card}]")
        check(again, f"{name}: two runs of the refinement differ")
    kvo = trackers["BA window"]
    for k, p in zip(kvo.keyframes, snaps["BA window"]):
        k.pose = p.copy()
    kvo.finalize()  # the pose graph alone: the keyframes the refinement starts from
    from phovo_tpu_torch.parallel import bundle_adjustment as ba

    window = ("_refine_photometric", (None, BA_ITERATIONS, 8, 8, 1.0, 0.1, 0.3, 0.02))
    for path, args, budget in (window + (ba.DENSE_W_BUDGET_BYTES,),
                               ("_refine_photometric_global", (None, BA_ITERATIONS, 8, 1.0, 0.1, 6, 0.3, 0.02),
                                ba.DENSE_W_BUDGET_BYTES),
                               window + (0,)):
        on_card, on_cpu = keyframe_copy(kvo, cfg, TUM_FR1, dev), keyframe_copy(kvo, cfg, TUM_FR1, torch.device("cpu"))
        with mock.patch.object(ba, "DENSE_W_BUDGET_BYTES", budget):  # 0: every window on the sparse Schur path
            getattr(on_card, path)(*args)
            getattr(on_cpu, path)(*args)
        path += "" if budget else " (sparse windows)"
        err = max(float(np.abs(a.pose - b.pose).max()) for a, b in zip(on_card.keyframes, on_cpu.keyframes))
        moved = max(float(np.abs(a.pose - b.pose).max()) for a, b in zip(on_card.keyframes, kvo.keyframes))
        print(f"back-end {path} at damping 1.0: card vs CPU max|pose diff| {err:.3e} (the refinement moved the "
              f"poses by up to {moved:.3e}), map sizes {len(on_card.map_points)}, {len(on_cpu.map_points)} [{card}]")
        check(err <= BA_CPU_ATOL and moved > 10 * BA_CPU_ATOL and len(on_card.map_points) == len(on_cpu.map_points),
              f"{path}: the card's refinement is not the CPU's")
    return trackers, snaps


def phase_backend_timing(dev, trackers, snaps, card):
    """Phase 7g: the back-end's times, the card synchronized before each
    clock reading: finalize's pg_solve and photometric_ba for the window
    and global scopes on phase 4g's keyframes (three runs each, after the
    phase's own); optimize_photometric_bundle, dense and sparse in turns
    (dense, sparse, sparse, dense), on one global problem of BA_GLOBAL_KF
    room keyframes, then at damping 1.0 dense against sparse within
    BA_SCHUR_ATOL; optimize_bundle on BA_MAP_SCALE, sparse and dense in
    turns (the dense W and W V^-1 take 922 MB, over the 256 MB budget that
    schur='auto' keeps). Returns {row: ms}."""
    from phovo_tpu_torch.ops import se3
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.parallel import bundle_adjustment as ba
    from phovo_tpu_torch.parallel import photometric_ba as pba
    from phovo_tpu_torch.utils.synthetic import forward_trajectory

    rows = {}
    for name in ("BA window", "BA global"):
        kvo, kw = trackers[name], finalize_kwargs(BA_RUNS[name][:4])
        runs = []
        for _ in range(3):
            for k, p in zip(kvo.keyframes, snaps[name]):
                k.pose = p.copy()
            kvo.finalize(**kw)
            runs.append((1e3 * kvo.finalize_timings["pg_solve"], 1e3 * kvo.finalize_timings["photometric_ba"]))
        pg, pb = (float(np.median(x)) for x in zip(*runs))
        rows[f"finalize {name} pg_solve"], rows[f"finalize {name} photometric_ba"] = pg, pb
        print(f"layer back-end, finalize {name} over {len(kvo.keyframes)} VGA keyframes: pg_solve {pg:.3f} ms, "
              f"photometric_ba {pb:.3f} ms (median of {[tuple(round(v, 3) for v in r) for r in runs]}) [{card}]")

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    poses_cw = forward_trajectory(BA_GLOBAL_KF)
    I, D = render_room_frames(TUM_FR1, SHAPE, poses_cw)
    gt = se3.matrix_to_state_np(np.linalg.inv(np.stack(poses_cw))).astype(np.float32)
    states = gt.copy()  # 5 mm and 2.5 mrad of noise (tests/test_photometric_ba.py's room keyframes)
    states[1:, :3] += rng.normal(0.0, 0.005, (BA_GLOBAL_KF - 1, 3)).astype(np.float32)
    states[1:, 3:] += rng.normal(0.0, 0.0025, (BA_GLOBAL_KF - 1, 3)).astype(np.float32)
    problem = pba.build_photometric_global(np.stack(I), np.stack(D), states, TUM_FR1, grid=8, max_covis=6,
                                           occ_gate=0.3, device=dev)
    P, K = problem.points.shape[0], problem.obs_pose.shape[0]
    print(f"back-end global problem: {BA_GLOBAL_KF} room keyframes rendered and built in "
          f"{time.perf_counter() - t0:.1f} s: P = {P} landmarks, K = {K} observations")
    kw = dict(iterations=BA_ITERATIONS, damping=1e-4, robust_delta=0.1, robust_z_delta=0.02)
    d1 = cuda_ms(lambda: pba.optimize_photometric_bundle(problem, TUM_FR1, schur="dense", **kw), 3)
    s1 = cuda_ms(lambda: pba.optimize_photometric_bundle(problem, TUM_FR1, schur="sparse", **kw), 3)
    s2 = cuda_ms(lambda: pba.optimize_photometric_bundle(problem, TUM_FR1, schur="sparse", **kw), 3)
    d2 = cuda_ms(lambda: pba.optimize_photometric_bundle(problem, TUM_FR1, schur="dense", **kw), 3)
    dense = pba.optimize_photometric_bundle(problem, TUM_FR1, schur="dense", **kw)
    sparse = pba.optimize_photometric_bundle(problem, TUM_FR1, schur="sparse", **kw)
    diff = float((dense[0] - sparse[0]).abs().max())
    start_cost = float(pba.optimize_photometric_bundle(problem, TUM_FR1, iterations=0)[2])
    errs = [float(np.abs(x.cpu().numpy() - gt).max()) for x in (problem.pose_states, dense[0], sparse[0])]
    rows["photometric global dense"], rows["photometric global sparse"] = (d1 + d2) / 2, (s1 + s2) / 2
    print(f"layer back-end, optimize_photometric_bundle, {BA_GLOBAL_KF} VGA keyframes (P = {P}, K = {K}), "
          f"{BA_ITERATIONS} iterations: dense {(d1 + d2) / 2:.3f} ms ({d1:.3f}, {d2:.3f}), sparse "
          f"{(s1 + s2) / 2:.3f} ms ({s1:.3f}, {s2:.3f}); cost {start_cost:.3f} -> dense {float(dense[2]):.3f}, "
          f"sparse {float(sparse[2]):.3f}; max|state - truth| {errs[0]:.3e} -> dense {errs[1]:.3e}, sparse "
          f"{errs[2]:.3e}; max|state dense - sparse| {diff:.3e} [{card}]")
    check(bool(torch.isfinite(dense[0]).all() and torch.isfinite(sparse[0]).all()), "non-finite global BA states")
    kw["damping"] = 1.0
    dense = pba.optimize_photometric_bundle(problem, TUM_FR1, schur="dense", **kw)
    sparse = pba.optimize_photometric_bundle(problem, TUM_FR1, schur="sparse", **kw)
    diff = float((dense[0] - sparse[0]).abs().max())
    moved = float((dense[0] - problem.pose_states).abs().max())
    errs = [float(np.abs(x.cpu().numpy() - gt).max()) for x in (dense[0], sparse[0])]
    print(f"back-end global problem at damping 1.0, {BA_ITERATIONS} iterations: cost {start_cost:.3f} -> dense "
          f"{float(dense[2]):.3f}, sparse {float(sparse[2]):.3f}; max|state - truth| dense {errs[0]:.3e}, sparse "
          f"{errs[1]:.3e}; the poses moved up to {moved:.3e}; max|state dense - sparse| {diff:.3e} (limit "
          f"{BA_SCHUR_ATOL:g}) [{card}]")
    check(diff <= BA_SCHUR_ATOL and moved > 10 * BA_SCHUR_ATOL and float(dense[2]) < start_cost,
          "the global BA's dense and sparse Schur steps disagree at damping 1.0")
    del problem, dense, sparse

    t0 = time.perf_counter()
    host, _, _ = ba.make_synthetic_ba(**BA_MAP_SCALE)
    problem = ba.BAProblem(*(ba.to_tensor(x, dev, torch.int64 if k in (2, 3) else torch.float32)
                             for k, x in enumerate(host)))
    M, P, K = BA_MAP_SCALE["n_poses"], BA_MAP_SCALE["n_points"], len(host.obs_pose)
    pairs = len(ba.build_schur_pairs(host.obs_pose, host.obs_point)[0])
    print(f"back-end map-scale problem: {M} poses, {P} landmarks, {K} observations, {pairs} Schur pairs, dense "
          f"W + W V^-1 {2 * M * P * 18 * 4 / 1e6:.0f} MB (auto routes to "
          f"{ba.schur_route('auto', M, P)}), made in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    s1 = cuda_ms(lambda: ba.optimize_bundle(problem, TUM_FR1, iterations=BA_MAP_ITERATIONS, schur="sparse"), 2)
    sparse_peak = torch.cuda.max_memory_allocated()
    d1 = cuda_ms(lambda: ba.optimize_bundle(problem, TUM_FR1, iterations=BA_MAP_ITERATIONS, schur="dense"), 2)
    dense_peak = torch.cuda.max_memory_allocated()
    d2 = cuda_ms(lambda: ba.optimize_bundle(problem, TUM_FR1, iterations=BA_MAP_ITERATIONS, schur="dense"), 2)
    s2 = cuda_ms(lambda: ba.optimize_bundle(problem, TUM_FR1, iterations=BA_MAP_ITERATIONS, schur="sparse"), 2)
    dense = ba.optimize_bundle(problem, TUM_FR1, iterations=BA_MAP_ITERATIONS, schur="dense")
    sparse = ba.optimize_bundle(problem, TUM_FR1, iterations=BA_MAP_ITERATIONS, schur="sparse")
    diff = float((dense[0] - sparse[0]).abs().max())
    rows["map-scale sparse"], rows["map-scale dense"] = (s1 + s2) / 2, (d1 + d2) / 2
    print(f"layer back-end, optimize_bundle map scale, {BA_MAP_ITERATIONS} iterations: sparse {(s1 + s2) / 2:.3f} ms "
          f"({s1:.3f}, {s2:.3f}), peak {sparse_peak / 2**20:.0f} MiB; dense {(d1 + d2) / 2:.3f} ms ({d1:.3f}, "
          f"{d2:.3f}), peak {dense_peak / 2**20:.0f} MiB; max|state dense - sparse| {diff:.3e}; costs "
          f"{float(dense[2]):.6f}, {float(sparse[2]):.6f} [{card}]")
    check(bool(torch.isfinite(sparse[0]).all()) and float(sparse[2]) < float(
        ba.optimize_bundle(problem, TUM_FR1, iterations=0)[2]), "the map-scale BA did not lower its cost")
    return rows


def phase_lin_timing(fb, dev, card):
    """Phase 7b's K-LIN rows: one bilinear linearization of B = 1 and 16
    pairs at every VGA level at the rule's split (lin_split(H, W) blocks a
    pair), through its C entry (the kernel: the two launches of the split
    layout, nothing else) and through the wrapper (its Python, checks and
    allocations too: host-paced where the kernel is short), against the
    plain version, in turns (plain, kernel, wrapper, wrapper, kernel,
    plain), beside the bound. Returns {(B, level): (kernel ms, plain ms,
    bound, wrapper ms)}."""
    from phovo_tpu_torch.ops import _build

    fn, names = _build.library().phovo_fused_lin, entry_names("lin")
    rows = {}
    for group, label, _, args, kw in lin_workloads(dev, (1, 16), ("bilinear",)):
        B, level = args[0].shape[0], int(label.split()[1])
        run = entry_launcher(fn, names, "lin", args, kw)
        p1 = cuda_ms(lambda: fb.fused_lin_batch_reference(*args, **kw), 3)
        k1 = cuda_ms(run[0], REPEATS)
        w1 = cuda_ms(lambda: fb.fused_lin_batch(*args, **kw), REPEATS)
        w2 = cuda_ms(lambda: fb.fused_lin_batch(*args, **kw), REPEATS)
        k2 = cuda_ms(run[0], REPEATS)
        p2 = cuda_ms(lambda: fb.fused_lin_batch_reference(*args, **kw), 3)
        k, p, w = (k1 + k2) / 2, (p1 + p2) / 2, (w1 + w2) / 2
        b = bound(*lin_case_work(args, kw, run[1]))
        rows[B, level] = (k, p, b, w)
        print(f"layer one-linearization kernel: {label}, B = {B}, G = {fb.lin_split(kw['H'], kw['W'])} blocks a "
              f"pair: kernel {k:.4f} ms ({k1:.4f}, {k2:.4f}), through the wrapper {w:.4f} ms ({w1:.4f}, {w2:.4f}), "
              f"plain {p:.4f} ms ({p1:.4f}, {p2:.4f}), bound {b[0]:.5f} ms ({b[1]}), the kernel at {b[0] / k:.1%} "
              f"of it [{card}]")
    return rows


def phase_cluster_timing(frames, dev, card):
    """Phase 7f: each of cluster_workloads' launches at the rule's cluster
    size against one block a pair, through the C entries in turns (one,
    rule, rule, one), with the states' largest difference and the pairs
    whose iteration counts differ (a converged trust-region pair stops on
    float32 noise). Returns {group: (rule ms, one-block ms)} over its
    levels."""
    from phovo_tpu_torch.ops import _build
    from phovo_tpu_torch.ops.fused_batch import cluster_size

    lib = _build.library()
    totals = {}
    for group, label, kind, args, kw in cluster_workloads(dev, frames):
        fn, names = getattr(lib, LEVEL_ENTRIES[kind][1]), entry_names(kind)
        c = cluster_size(kw["H"], kw["W"])
        rule = entry_launcher(fn, names, kind, args, kw)
        one = entry_launcher(fn, names, kind, args, kw, 1)
        o1 = cuda_ms(one[0], REPEATS)
        r1 = cuda_ms(rule[0], REPEATS)
        r2 = cuda_ms(rule[0], REPEATS)
        o2 = cuda_ms(one[0], REPEATS)
        r, o = (r1 + r2) / 2, (o1 + o2) / 2
        diff = float((rule[1] - one[1]).abs().max())
        n_it = int((rule[2][:, 0] != one[2][:, 0]).sum())
        acc = totals.setdefault(group, [0.0, 0.0])
        acc[0] += r
        acc[1] += o
        print(f"layer cluster layout, {group}, {label}: C = {c} {r:.4f} ms ({r1:.4f}, {r2:.4f}), C = 1 {o:.4f} ms "
              f"({o1:.4f}, {o2:.4f}), C / one block {r / o:.4f}; max|state diff| {diff:.3e}, "
              f"{n_it} pairs with other iteration counts [{card}]")
    for group, (r, o) in totals.items():
        print(f"cluster layout {group}: rule {r:.4f} ms, one block a pair {o:.4f} ms, {r / o:.4f} [{card}]")
    return totals



# the diagnostics path (phases 4h, 4i, 6g, 7h): the iteration trace through
# K-LIN on one VGA pair, bilinear, the analytic preset's budgets run in
# full; jacfwd on one VGA pair of the ceres preset; the port's parity
# harness on the cluttered scene; profiler windows of a serving step and of
# an LM iteration of finalize's photometric bundle adjustment
TRACE_CASES = (("warped", {}), ("esm", {"gradient_at": "esm"}),
               ("tdist", {"robust_loss": "tdist", "robust_delta": LOSS_DELTAS["tdist"]}))
# tests/test_autodiff_modes.py:25: jacfwd and the linearizer agree to this
JACFWD_ATOL = 5e-3
PARITY_SCENE = dict(scene="cluttered", shape=(240, 320), frames=10)
PARITY_OUT = "artifacts/parity_torch_cluttered_qvga"


def trace_config(**overrides):
    """The analytic preset, bilinear, every budget run in full (min
    gradient norm 0), visualize_iterations on."""
    from phovo_tpu_torch.utils.config import config_from_dict

    return dataclasses.replace(
        config_from_dict({**ANALYTIC_PRESET, "min_gradient_norms": [0] * 5, "visualize_iterations": True}),
        sampling="bilinear", **overrides)


def decode_png(path) -> np.ndarray:
    """An 8-bit grayscale PNG of utils/viz.save_image's layout (one IDAT
    stream, filter type 0 on every row) decoded with zlib alone."""
    import struct
    import zlib

    data = open(path, "rb").read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        chunks.setdefault(data[pos + 4:pos + 8], []).append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    W, H, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][0][:10])
    check((depth, colour) == (8, 0), f"{path}: not 8-bit grayscale")
    rows = np.frombuffer(zlib.decompress(b"".join(chunks[b"IDAT"])), np.uint8).reshape(H, W + 1)
    check(bool((rows[:, 0] == 0).all()), f"{path}: a row filter other than 0")
    return rows[:, 1:]


def trace_pair(dev):
    """One synthetic VGA pair on the card: (u8 intensity, metric depth) of
    frames 0 and 1 of make_sequence at TUM fr1."""
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.utils.synthetic import make_sequence

    I, D, _, _ = make_sequence(TUM_FR1, SHAPE, 2)
    I8 = [np.round(i * 255.0).astype(np.uint8) for i in I]
    return [torch.from_numpy(x).to(dev) for x in (I8[0], D[0], I8[1], D[1])]


def phase_trace(fb, dev, card):
    """Phase 4h: utils/trace.trace_alignment on one VGA pair, 'warped',
    'esm' and 'warped' with the Student-t loss, the budgets of
    trace_config: through K-LIN (its launches counted from 0: one a
    record, and one a burn-in step with tdist), then with the linearizer
    forced to its plain version, on the card; the same records, levels and
    iterations, states within STATE_ATOL, valid counts equal or accounted
    for by edge pixels (explain_valid_diff). Returns {case: K-LIN
    launches}."""
    from phovo_tpu_torch.ops import fused as fused_ops
    from phovo_tpu_torch.ops import pyramid as pyr
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.ops.robust import TDIST_BURNIN
    from phovo_tpu_torch.utils.trace import trace_alignment

    si, sd, ti, td = trace_pair(dev)
    launches = {}
    for name, overrides in TRACE_CASES:
        cfg = trace_config(**overrides)
        reset_counts(fb)
        t0 = time.perf_counter()
        kern = trace_alignment(si, sd, ti, td, TUM_FR1, cfg, device=dev)
        wall = time.perf_counter() - t0
        counts = launch_counts(fb)
        launches[name] = counts["K-LIN"]
        t0 = time.perf_counter()
        with mock.patch.object(fused_ops, "fused_lin_batch", fb.fused_lin_batch_reference):
            plain = trace_alignment(si, sd, ti, td, TUM_FR1, cfg, device=dev)
        plain_wall = time.perf_counter() - t0
        check(launch_counts(fb) == counts, f"trace {name}: the plain run launched a kernel")
        expect = len(kern) + (TDIST_BURNIN if cfg.robust_loss == "tdist" else 0)
        others = {k: v for k, v in counts.items() if v and k != "K-LIN"}
        check(launches[name] == expect and not others,
              f"trace {name}: K-LIN launches {launches[name]}, expected {expect} (records {len(kern)}); others {others}")
        check([(r.level, r.iteration) for r in kern] == [(r.level, r.iteration) for r in plain],
              f"trace {name}: the records' levels and iterations differ")
        err = max(float(np.abs(a.state - b.state).max()) for a, b in zip(kern, plain))
        check(err <= STATE_ATOL, f"trace {name}: state diff {err}")
        n_diff = 0
        prev_k = prev_p = np.zeros(6, np.float32)
        for a, b in zip(kern, plain):
            if a.num_valid != b.num_valid:
                n_diff += 1
                H, W = pyr.level_shape(SHAPE, a.level)
                intr = TUM_FR1.at_level(a.level)
                d0 = pyr.build_pyramid(sd, cfg.num_levels)[a.level]
                geom = fused_ops.pack_geometry(d0, intr, cfg.min_depth, cfg.max_depth)[None]

                def res(state, nv):
                    return SimpleNamespace(state=torch.from_numpy(state).to(dev)[None],
                                           num_valid=torch.tensor([nv], device=dev))

                explain_valid_diff(fb, geom, intr, H, W, res(prev_k, a.num_valid), res(prev_p, b.num_valid),
                                   f"trace {name} level {a.level} iteration {a.iteration}")
            prev_k, prev_p = a.state, b.state
        per_level = {lv: sum(1 for r in kern if r.level == lv) for lv in sorted({r.level for r in kern}, reverse=True)}
        print(f"trace {name}: one VGA pair, records by level {per_level}, K-LIN launches {launches[name]} (records "
              f"{len(kern)}{f' + {TDIST_BURNIN} burn-in' if cfg.robust_loss == 'tdist' else ''}); kernel vs plain "
              f"max|state diff| {err:.3e}, valid counts differing in {n_diff} records (edge pixels), last cost "
              f"{kern[-1].cost:.6f} / {plain[-1].cost:.6f}, gnorm {kern[-1].gradient_norm:.4f} / "
              f"{plain[-1].gradient_norm:.4f}; wall {1e3 * wall:.1f} ms through K-LIN, {1e3 * plain_wall:.1f} ms plain "
              f"(host-paced: every record reads its norm) [{card}]")
    return launches


def phase_cli_diffs(fb, dev, card, I8, D16, seq, intr, spec, tmp):
    """Phase 4f's difference-image runs, on its raw frames: phovo-vo frame
    mode with --save-diff-dir over CLI_FRAME_MODE_PAIRS pairs (one PNG a
    pair, each decoding to alignment_diff at the pair's state from
    --metrics), and phovo-align on the first pair as .npy frames with
    --save-diff and --save-diff-dir under the analytic preset with
    visualize_iterations on (one PNG a replayed iteration, each decoding to
    the in-process trace's image; the --save-diff PNG to alignment_diff at
    the object API's result). Returns {run: launches}."""
    import contextlib
    import io

    from phovo_tpu_torch.apps import phovo_align, phovo_vo
    from phovo_tpu_torch.models import BACKENDS
    from phovo_tpu_torch.utils import config as C
    from phovo_tpu_torch.utils.trace import trace_alignment
    from phovo_tpu_torch.utils.viz import alignment_diff

    device = "cpu" if dev.type == "cpu" else "cuda"
    depth = [d.astype(np.float32) * np.float32(DEPTH_SCALE) for d in D16[:CLI_FRAME_MODE_PAIRS + 1]]
    launches = {}

    def counted(name, run):
        reset_counts(fb)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = run()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        check(rc == 0, f"{name} exited with {rc}")
        launches[name] = launch_counts(fb)
        return time.perf_counter() - t0, buf.getvalue()

    preset = C.builtin_config_dir() / f"{CLI_PRESETS['analytic']}.yml"
    diffs, metrics = tmp / "vo_diffs", tmp / "vo_metrics.jsonl"
    wall, _ = counted("phovo-vo frame mode --save-diff-dir", lambda: phovo_vo.main(
        ["--config", str(preset), "--dataset", str(seq), "--output", str(tmp / "vo_diff.txt"), "--intrinsics", spec,
         "--loader", "raw", "--max-frames", str(CLI_FRAME_MODE_PAIRS), "--save-diff-dir", str(diffs), "--metrics",
         str(metrics), "--device", device, "-q"]))
    pngs = sorted(diffs.glob("*.png"))
    states = [np.asarray(json.loads(ln)["relative_state"], np.float32) for ln in metrics.read_text().splitlines()]
    check([p.name for p in pngs] == [f"diff_{k:06d}.png" for k in range(1, CLI_FRAME_MODE_PAIRS + 1)]
          and len(states) == CLI_FRAME_MODE_PAIRS, f"phovo-vo --save-diff-dir wrote {[p.name for p in pngs]}")
    for k, (png, state) in enumerate(zip(pngs, states)):
        want = np.clip(alignment_diff(I8[k], depth[k], I8[k + 1], state, intr, device=dev), 0, 255).astype(np.uint8)
        check(np.array_equal(decode_png(png), want), f"{png.name} is not alignment_diff at its pair's state")
    got = launches["phovo-vo frame mode --save-diff-dir"]
    active = sum(1 for n in C.load_config(preset).max_iterations if n > 0)
    check(got["K-GN"] == active * CLI_FRAME_MODE_PAIRS and got["K-LIN"] == 0, f"frame mode --save-diff-dir {got}")
    print(f"CLI phovo-vo frame mode --save-diff-dir: {CLI_FRAME_MODE_PAIRS} pairs in {wall:.3f} s, "
          f"{len(pngs)} PNGs, each zlib-decoded equal to alignment_diff at its pair's state; launches {got} [{card}]")

    npys = []
    for k, a in enumerate((I8[0], D16[0], I8[1], D16[1])):
        npys.append(tmp / f"align{k}.npy")
        np.save(npys[-1], a)
    vis = tmp / "visualize.yml"
    vis.write_text(preset.read_text().replace("visualize_iterations: false", "visualize_iterations: true"))
    cfg = C.load_config(vis)
    check(cfg.visualize_iterations, "the visualize preset did not turn visualize_iterations on")
    iters, one = tmp / "align_iters", tmp / "align_diff.png"
    wall, out = counted("phovo-align --save-diff-dir", lambda: phovo_align.main(
        [str(vis), *map(str, npys), "--intrinsics", spec, "--depth-scale", repr(DEPTH_SCALE), "--save-diff", str(one),
         "--save-diff-dir", str(iters), "--device", device]))
    got = launches["phovo-align --save-diff-dir"]
    d0, d1 = (D16[k].astype(np.float32) * DEPTH_SCALE for k in (0, 1))
    records = trace_alignment(I8[0], d0, I8[1], d1, intr, cfg, device=dev)
    pngs = sorted(iters.glob("*.png"))
    names = [f"level{r.level}_iter{r.iteration:03d}.png" for r in records]
    check(sorted(names) == [p.name for p in pngs] and f"wrote {len(records)} per-iteration diff images" in out,
          f"phovo-align --save-diff-dir wrote {[p.name for p in pngs]}, the trace has {names}")
    for name, rec in zip(names, records):
        want = np.clip(alignment_diff(I8[0].astype(np.float32) / 255.0, d0, I8[1].astype(np.float32) / 255.0,
                                      rec.state, intr, device=dev) * 255.0, 0, 255).astype(np.uint8)
        check(np.array_equal(decode_png(iters / name), want), f"{name} is not the trace's image")
    vo = BACKENDS["analytic"](cfg, device=dev)
    vo.set_intrinsic_matrix(intr.matrix())
    vo.set_source_frame(I8[0], d0)
    vo.set_target_frame(I8[1], d1)
    vo.set_initial_state_vector(np.zeros(6, np.float32))
    state = vo.optimize().state.cpu().numpy()
    check(np.array_equal(decode_png(one), alignment_diff(I8[0], d0, I8[1], state, intr, device=dev).astype(np.uint8)),
          "the --save-diff PNG is not alignment_diff at the result")
    # one K-GN launch a level for the alignment, one K-LIN launch a record
    check(got["K-LIN"] == len(records) and got["K-GN"] == active, f"phovo-align --save-diff-dir launches {got}")
    print(f"CLI phovo-align --save-diff --save-diff-dir (analytic preset, visualize_iterations): {wall:.3f} s, "
          f"{len(pngs)} per-iteration PNGs and the result's, each zlib-decoded equal to the in-process images; "
          f"K-LIN launches {got['K-LIN']} (the replay's records), K-GN {got['K-GN']} [{card}]")
    return launches


def phase_jacfwd(dev, card):
    """Phase 6g: one VGA pair through align_autodiff with the ceres preset,
    jacobian_mode 'jacfwd' (torch.func.jacfwd over the residual, plain
    torch) against 'linearizer' (K-TR), states within JACFWD_ATOL; ms a
    pair of each, Stopwatch-timed (median of 3 after a warm-up). Returns
    the jacfwd ms."""
    from phovo_tpu_torch.models import autodiff
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.utils.config import config_from_dict
    from phovo_tpu_torch.utils.profiling import Stopwatch

    cfg = config_from_dict(CERES_PRESET)
    si, sd, ti, td = trace_pair(dev)
    zero = torch.zeros(6, device=dev)
    out, ms = {}, {}
    for mode in ("jacfwd", "linearizer"):
        autodiff.align_autodiff(si, sd, ti, td, TUM_FR1, zero, cfg, mode)  # warm-up
        times = []
        for _ in range(3):
            sw = Stopwatch().start()
            out[mode] = autodiff.align_autodiff(si, sd, ti, td, TUM_FR1, zero, cfg, mode)
            times.append(1e3 * sw.stop(out[mode]))
        ms[mode] = float(np.median(times))
    err = float((out["jacfwd"].state - out["linearizer"].state).abs().max())
    print(f"jacfwd: one VGA pair, the ceres preset: jacfwd {ms['jacfwd']:.3f} ms a pair, linearizer (K-TR) "
          f"{ms['linearizer']:.3f} ms (Stopwatch, medians of 3); iterations jacfwd "
          f"{out['jacfwd'].iterations.tolist()}, linearizer {out['linearizer'].iterations.tolist()}; valid counts "
          f"{out['jacfwd'].num_valid.tolist()}; max|state jacfwd - linearizer| {err:.3e} (limit {JACFWD_ATOL:g}) "
          f"[{card}]")
    check(err <= JACFWD_ATOL and bool(torch.isfinite(out["jacfwd"].state).all()), f"jacfwd vs linearizer {err}")
    check(bool((out["jacfwd"].num_valid[out["jacfwd"].iterations > 0] > 0).all()), "jacfwd reported no valid pixels")
    return ms["jacfwd"]


def phase_parity(dev, card):
    """Phase 4i: tools/parity_harness_torch on PARITY_SCENE, every shipped
    preset, the port on the card (the oracle on the host; NumpyCV2 where
    cv2 is missing), written to PARITY_OUT .md and .json. Every ATE must
    be finite; the rows are printed."""
    import pathlib

    from tools import parity_harness_torch as harness

    t0 = time.perf_counter()
    shape = PARITY_SCENE["shape"]
    I, D, gt_poses, K = harness.scene_frames(PARITY_SCENE["scene"], shape, PARITY_SCENE["frames"])
    rows = harness.run_harness(I, D, gt_poses, K, harness.ALL_PRESETS, dev,
                               out=lambda s: print(f"parity: {s} [{card}]", flush=True))
    meta = {"frames": PARITY_SCENE["frames"], "shape": list(shape), "scene": PARITY_SCENE["scene"],
            "motion_scale": 1.0, "device": f"{torch.device(dev)} ({card})",
            "oracle_opencv": "cv2" if harness.oracle_module().cv2 is not harness.NumpyCV2 else "NumpyCV2"}
    out = pathlib.Path(__file__).resolve().parent / PARITY_OUT
    out.parent.mkdir(exist_ok=True)
    harness.write_tables(rows, meta, f"{out}.md", f"{out}.json")
    wall = time.perf_counter() - t0
    check(len(rows) == 15 and all(np.isfinite([r["ate_fw_vs_oracle"], r["ate_fw_vs_gt"], r["ate_oracle_vs_gt"]]).all()
                                  for r in rows), "the parity table has non-finite or missing rows")
    print(f"parity: {len(rows)} rows ({PARITY_SCENE['scene']}, {shape[0]}x{shape[1]}, {PARITY_SCENE['frames']} "
          f"frames, oracle OpenCV {meta['oracle_opencv']}) in {wall:.1f} s, written to {PARITY_OUT}.md/.json [{card}]")
    return wall


def profiled(name, fn, card, log_dir):
    """fn() once as warm-up, then once inside utils/profiling.trace:
    prints and returns its trace_summary."""
    from phovo_tpu_torch.utils.profiling import trace, trace_summary

    fn()
    torch.cuda.synchronize()
    with trace(log_dir) as window:
        fn()
    s = trace_summary(window)
    print(f"profile {name}: {s['kernel_launches']} kernel launches, device busy {s['device_busy_ms']:.3f} ms of "
          f"{s['wall_ms']:.3f} ms wall (host share {1 - s['device_busy_ms'] / s['wall_ms']:.3f}) [{card}]")
    return s


def phase_profiles(dev, I8, D16, trackers, snaps, card):
    """Phase 7h: the kernel launches, device-busy and wall ms of a traced
    window (utils/profiling.trace): one serving step (align_sequences_multi,
    S = 8 streams, one time step of phase 7e's frames, the analytic
    preset), and one LM iteration of finalize's photometric bundle
    adjustment: the problem and arguments finalize passes for phase 4g's
    BA global keyframes, run for 1 and 2 iterations, the difference. The
    traces go to build/phovo_tpu_torch/profiles. Returns {row: summary}."""
    from phovo_tpu_torch.models import keyframe
    from phovo_tpu_torch.ops import _build
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.parallel import batch
    from phovo_tpu_torch.utils.config import config_from_dict

    logs = _build.BUILD_DIR / "profiles"
    rows = {}
    I, _, D = serve_streams(I8, D16, dev)
    cfg = config_from_dict(ANALYTIC_PRESET)
    rows["serving step"] = profiled(f"one serving step (align_sequences_multi, S = {I.shape[0]}, one time step)",
                                    lambda: batch.align_sequences_multi(I[:, :2], D[:, :2], TUM_FR1, cfg), card,
                                    logs / "serving_step")
    del I, D

    kvo, kw = trackers["BA global"], finalize_kwargs(BA_RUNS["BA global"][:4])
    captured = {}
    real = keyframe.optimize_photometric_bundle

    def capture(problem, intr, **kwargs):
        captured.update(problem=problem, intr=intr, kwargs=kwargs)
        return real(problem, intr, **kwargs)

    for k, p in zip(kvo.keyframes, snaps["BA global"]):
        k.pose = p.copy()
    with mock.patch.object(keyframe, "optimize_photometric_bundle", capture):
        kvo.finalize(**kw)
    check("problem" in captured, "finalize did not run the photometric bundle adjustment")
    lm = {}
    for n in (1, 2):
        args = {**captured["kwargs"], "iterations": n}
        lm[n] = profiled(f"photometric_ba of finalize (BA global, {len(kvo.keyframes)} VGA keyframes), {n} "
                         f"iteration{'s' if n > 1 else ''}",
                         lambda: real(captured["problem"], captured["intr"], **args), card, logs / f"ba_{n}")
    one = {k: lm[2][k] - lm[1][k] for k in lm[1]}
    print(f"profile one LM iteration of finalize's photometric_ba (2 iterations minus 1): {one['kernel_launches']} "
          f"kernel launches, device busy {one['device_busy_ms']:.3f} ms of {one['wall_ms']:.3f} ms wall (host share "
          f"{1 - one['device_busy_ms'] / one['wall_ms']:.3f}) [{card}]")
    rows["photometric_ba 1 iteration"], rows["photometric_ba 2 iterations"] = lm[1], lm[2]
    rows["photometric_ba LM iteration"] = one
    return rows


def prep_bytes(packs, *tensors) -> int:
    """Bytes K-PREP reads and writes once: the given tensors and every
    pack."""
    return nbytes(*tensors) + sum(nbytes(*p) for p in packs.values())


def phase_prep(I8, D16, dev, card):
    """Phase 7i: K-PREP against the torch chain on the main paths' chunk,
    and the launches of the main paths. Returns the record's fields."""
    from phovo_tpu_torch.models import analytic, autodiff
    from phovo_tpu_torch.ops import _build
    from phovo_tpu_torch.ops import prep
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.utils.config import config_from_dict

    ci = prep.device_unit_intensity(torch.from_numpy(I8[0]).to(dev))
    cd = torch.from_numpy(D16[0]).to(dev).to(torch.float32) * float(np.float32(DEPTH_SCALE))
    Ii, Dd = torch.from_numpy(I8[1:]).to(dev), torch.from_numpy(D16[1:]).to(dev)
    n = Ii.shape[0]
    cfg_tr, cfg_an = config_from_dict(CERES_PRESET), config_from_dict(ANALYTIC_PRESET)
    rows = {}
    for name, cfg in (("ceres", cfg_tr), ("analytic", cfg_an)):
        def kernel():
            return prep.prep_chunk(ci, cd, Ii, Dd, DEPTH_SCALE, TUM_FR1, cfg)

        def plain():
            I, D = prep.chunk_device_prep(ci, cd, Ii, Dd, DEPTH_SCALE)
            return prep.prep_levels_torch(I, D, TUM_FR1, cfg), I[-1], D[-1]

        before = prep.PREP_LAUNCHES
        (packs, kci, kcd), (full, pci, pcd) = kernel(), plain()
        torch.cuda.synchronize()
        check(prep.PREP_LAUNCHES == before + 1, f"K-PREP {name}: not one launch a call")
        for level, (i0, geom, t_all) in packs.items():
            p0, pg, pt = full[level]
            check(torch.equal(i0, p0[:-1]) and torch.equal(geom, pg[:-1]) and torch.equal(t_all, pt[1:]),
                  f"K-PREP {name}: level {level}'s packs differ from the torch chain's")
        check(torch.equal(kci, pci) and torch.equal(kcd, pcd), f"K-PREP {name}: the carry differs")
        p1 = cuda_ms(plain, 3)
        k1 = cuda_ms(kernel, REPEATS)
        k2 = cuda_ms(kernel, REPEATS)
        p2 = cuda_ms(plain, 3)
        k, p = (k1 + k2) / 2, (p1 + p2) / 2
        least = bound(prep_bytes(packs, ci, cd, Ii, Dd, kci, kcd), 0.0)
        print(f"K-PREP {name} chunk ({n + 1} VGA frames, levels {sorted(packs)}): packs and carry equal to the "
              f"torch chain's; kernel {k:.4f} ms ({k1:.4f}, {k2:.4f}), {k / n:.5f} ms a frame; bound "
              f"{least[0]:.4f} ms ({least[1]}, {100 * least[0] / k:.1f}% of it); torch chain {p:.4f} ms "
              f"({p1:.4f}, {p2:.4f}), {p / n:.5f} ms a frame [{card}]")
        rows[name] = {"ms": k, "plain_ms": p, "bound_ms": least[0], "bound_by": least[1]}
        del packs, full

    # the main paths' launches under a profiler window, K-PREP's and the
    # torch chain's counts beside them
    logs = _build.BUILD_DIR / "profiles"
    vo = autodiff.PhotoconsistencyOdometryAutodiff(cfg_tr, device=dev)
    vo.set_intrinsic_matrix([[TUM_FR1.fx, 0, TUM_FR1.cx], [0, TUM_FR1.fy, TUM_FR1.cy], [0, 0, 1]])
    depth = [D16[k].astype(np.float32) * np.float32(DEPTH_SCALE) for k in range(2)]

    def live_pair():
        vo.set_source_frame(I8[0], depth[0])
        vo.set_target_frame(I8[1], depth[1])
        vo.set_initial_state_vector(np.zeros(6))
        return vo.optimize().state.cpu()

    paths = {
        "analytic chunk": lambda: analytic.align_sequence_chunk(ci, cd, Ii, Dd, TUM_FR1, cfg_an,
                                                                depth_scale=DEPTH_SCALE)[0].state.cpu(),
        "ceres chunk": lambda: autodiff.align_sequence_chunk_autodiff(ci, cd, Ii, Dd, TUM_FR1, cfg_tr,
                                                                      depth_scale=DEPTH_SCALE)[0].state.cpu(),
        "ceres object-API pair": live_pair,
    }
    launches = {}
    for name, fn in paths.items():
        prep.PREP_LAUNCHES = prep.PREP_TORCH_CALLS = 0
        s = profiled(name, fn, card, logs / name.replace(" ", "_"))
        counts = (prep.PREP_LAUNCHES, prep.PREP_TORCH_CALLS)
        print(f"K-PREP {name}: K-PREP launches {counts[0]}, torch chain calls {counts[1]} over two calls")
        check(counts == (2, 0), f"{name}: prep did not run as one K-PREP launch a call")
        launches[name] = {"kernel_launches": s["kernel_launches"], "frames": n if "chunk" in name else 1}
    return {"by_chunk": rows, "main_path_launches": launches}


# phase 4j: the mesh forms (parallel/mesh.py) on the one card: one rank in
# an NCCL group in this process, then two ranks sharing the card over gloo
# (NCCL refuses two ranks on one device), spawned, the library built first.
# The pixel-sharded aligner's schedule: bilinear, no early exit (an early
# exit at a threshold, or nearest sampling, turns the all-reduce's rounding
# into other iteration counts or sample flips); 5 and 10 iterations at the
# three coarse levels
MESH_PIXEL_CFG = dict(num_levels=5, blur_filter_sizes=(0,) * 5, gradient_scales=(0.0625,) * 5,
                      max_iterations=(0, 0, 5, 10, 10), lambda_steps=(1.0,) * 5, min_gradient_norms=(0.0,) * 5,
                      sampling="bilinear")
MESH_B_ODD = 255  # the dp aligner again on the first 255 pairs: data = 2 pads it
MESH_ATOL = 1e-5  # the all-reduced forms against the unsharded call (BA at damping 1.0)


def mesh_inputs(I8, D16, kvo, snap):
    """Phase 4j's inputs as host arrays (what the spawned ranks load): the
    main path's frames, the serving streams of phase 4e, phase 4g's
    keyframes at their poses before finalize with their edges, and the
    map-scale BA problem."""
    from phovo_tpu_torch.parallel import bundle_adjustment as ba

    problem, _, _ = ba.make_synthetic_ba(**BA_MAP_SCALE)
    step = SERVE_FRAMES - 1
    idx = np.stack([np.arange(s * step, s * step + SERVE_FRAMES) for s in range(SERVE_STREAMS)])
    closures = [(lc.from_kf, lc.to_kf, lc.relative, lc.mean_residual) for lc in kvo.loop_closures]
    return dict(
        I8=I8, D16=D16, batches=(len(I8) - 1, min(MESH_B_ODD, len(I8) - 2)), serve_idx=idx, ba=tuple(problem),
        kf=dict(I=np.stack([k.intensity for k in kvo.keyframes]), D=np.stack([k.depth for k in kvo.keyframes]),
                poses=np.stack(snap), edges=list(kvo.odometry_edges), closures=closures,
                meta=[(k.index, k.frame_index, k.timestamp) for k in kvo.keyframes]),
    )


def mesh_tracker(kf, dev):
    """A back-end tracker on dev holding phase 4g's keyframes at their
    poses before finalize, with their odometry and loop edges."""
    from phovo_tpu_torch.models.keyframe import Keyframe, LoopClosure
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.utils import config as C

    kvo = backend_tracker(C.load_config(C.builtin_config_dir() / f"{BA_PRESET}.yml"), TUM_FR1, dev)
    for (index, frame_index, ts), I, D, pose in zip(kf["meta"], kf["I"], kf["D"], kf["poses"]):
        kvo.keyframes.append(Keyframe(index=index, frame_index=frame_index, timestamp=ts, intensity=I, depth=D,
                                      pose=pose.copy(), device=dev))
    kvo.odometry_edges = [(i, j, rel.copy()) for i, j, rel in kf["edges"]]
    kvo.loop_closures = [LoopClosure(i, j, rel.copy(), r) for i, j, rel, r in kf["closures"]]
    return kvo


def mesh_forms(inputs, mesh, dev, fb, pixel_mesh=None) -> dict:
    """Phase 4j's forms on `mesh`, every rank the same global inputs, each
    run's launches counted from 0 and its wall time taken after a
    synchronize: {form: (result on the host, launches, seconds)}. The
    data axis: make_data_parallel_aligner on the 256 main-path pairs and on
    MESH_B_ODD of them (K-GN, the bench schedule with early exit) and
    make_chunked_sequence_server on the 8 serving streams (K-GN, the
    analytic preset); the pixel axis: make_pixel_sharded_aligner on one
    pair, on pixel_mesh where given; the flattened mesh: finalize(mesh=)
    with BA(3) window and global at damping 1.0 and optimize_bundle(mesh=)
    at map scale at damping 1.0."""
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.parallel import batch
    from phovo_tpu_torch.parallel import bundle_adjustment as ba
    from phovo_tpu_torch.parallel.distributed import to_numpy
    from phovo_tpu_torch.parallel.sharded_ne import make_pixel_sharded_aligner
    from phovo_tpu_torch.utils.config import PhovoConfig, config_from_dict

    I8 = torch.from_numpy(np.asarray(inputs["I8"])).to(dev)
    Dm = torch.from_numpy(np.asarray(inputs["D16"])).to(dev).to(torch.float32) * float(np.float32(DEPTH_SCALE))
    out = {}

    def run(name, fn):
        reset_counts(fb)
        sync(dev)
        t0 = time.perf_counter()
        res = fn()
        sync(dev)
        out[name] = (to_numpy(res), launch_counts(fb), time.perf_counter() - t0)

    align = batch.make_data_parallel_aligner(mesh, bench_config(300.0), use_fused=True)
    for B in inputs["batches"]:
        run(f"dp aligner, B = {B}", lambda: align(I8[:B], Dm[:B], I8[1:B + 1], Dm[1:B + 1], TUM_FR1,
                                                  torch.zeros((B, 6), device=dev)))
    idx = np.asarray(inputs["serve_idx"])  # the streams gathered on the host (no uint16 indexing on the card)
    sI = torch.from_numpy(np.asarray(inputs["I8"])[idx]).to(dev)
    sD = torch.from_numpy(np.asarray(inputs["D16"])[idx]).to(dev)
    serve = batch.make_chunked_sequence_server(mesh, config_from_dict(ANALYTIC_PRESET), depth_scale=DEPTH_SCALE)
    carry_d = sD[:, 0].to(torch.float32) * float(np.float32(DEPTH_SCALE))
    run("chunked server", lambda: serve(sI[:, 0], carry_d, sI[:, 1:], sD[:, 1:], TUM_FR1))
    pixel = make_pixel_sharded_aligner(pixel_mesh or mesh, PhovoConfig(**MESH_PIXEL_CFG))
    run("pixel aligner", lambda: pixel(I8[0], Dm[0], I8[1], Dm[1], TUM_FR1, torch.zeros(6, device=dev)))
    for scope in ("window", "global"):
        def refine():
            kvo = mesh_tracker(inputs["kf"], dev)
            kvo.finalize(mesh=mesh, ba_iterations=BA_ITERATIONS, ba_scope=scope, ba_damping=1.0)
            return np.stack([k.pose for k in kvo.keyframes]), kvo.map_points

        run(f"finalize BA({BA_ITERATIONS}) {scope}", refine)
    problem = ba.BAProblem(*(ba.to_tensor(x, dev, torch.int64 if k in (2, 3) else torch.float32)
                             for k, x in enumerate(inputs["ba"])))
    run("optimize_bundle map scale", lambda: ba.optimize_bundle(problem, TUM_FR1, mesh=mesh, damping=1.0,
                                                                  iterations=BA_MAP_ITERATIONS, schur="auto"))
    return out


def sync(dev) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mesh_serve(streams, out_dir, devices, dev):
    """phovo-serve over the raw streams into out_dir, in process, --devices
    `devices`; returns its exit code."""
    from phovo_tpu_torch.apps import phovo_serve
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.utils import config as C

    cfg_path = C.builtin_config_dir() / f"{CLI_PRESETS['analytic']}.yml"
    return phovo_serve.main(["--config", str(cfg_path), *[a for d in streams for a in ("--dataset", str(d))],
                             "--out-dir", str(out_dir), "--chunk", str(CLI_CHUNK), "--devices", str(devices),
                             "--intrinsics", ",".join(repr(float(v)) for v in TUM_FR1), "--device",
                             "cpu" if dev.type == "cpu" else "cuda", "-q"])


def mesh_rank(inputs_path, streams, out_dir, dev_type):
    """A spawned rank of phase 4j: the forms on a mesh of the world's ranks
    along the data axis (the pixel aligner along the pixel axis), then
    phovo-serve --devices <world> into out_dir. Returns
    ({form: (result, launches, seconds)}, phovo-serve's exit code, its
    launches)."""
    import pickle

    import torch.distributed as dist

    from phovo_tpu_torch.ops import fused_batch as fb
    from phovo_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device(dev_type, 0) if dev_type == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    n = dist.get_world_size()
    data, pixel = (make_mesh(n, pixel_parallel=p, devices=[dev] * n) for p in (1, n))
    forms = mesh_forms(inputs, data, dev, fb, pixel_mesh=pixel)
    reset_counts(fb)
    rc = mesh_serve(streams, out_dir, n, dev)
    sync(dev)
    return forms, rc, launch_counts(fb)


def leaves(x) -> list:
    """A result's arrays, flattened (tuples, lists and NamedTuples)."""
    if isinstance(x, (tuple, list)):
        return [a for y in x for a in leaves(y)]
    return [np.asarray(x)]


def same_bits(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(x.shape == y.shape and np.array_equal(x, y) for x, y in zip(la, lb))


def max_diff(a, b) -> float:
    return max(float(np.abs(np.asarray(x, np.float64) - y).max(initial=0.0)) for x, y in zip(leaves(a), leaves(b)))


def phase_mesh(fb, dev, card, I8, D16, kvo, snap):
    """Phase 4j: the mesh forms (mesh_forms) on the card. The unsharded
    calls (a one-rank mesh with no process group: the single-device code),
    then one rank in an NCCL group in this process (a one-rank mesh makes
    no collective: the forms must give the unsharded bits; one all_reduce
    checks the group), then two ranks spawned over gloo sharing the card
    (distributed.spawn_ranks): data = 2 for the data-axis forms and the
    flattened ones, pixel = 2 for the pixel aligner. Checks: both ranks the
    same bits; the data-axis forms the unsharded bits, with K-GN launched
    on each rank; the all-reduced forms (the pixel aligner's states,
    finalize's keyframe poses with its map the same size, the map-scale
    BA's states and points) within MESH_ATOL; phovo-serve --devices 2 in
    the two ranks writes the files of the one-process run. Returns {run:
    K-GN launches}."""
    import pathlib
    import pickle
    import tempfile

    import torch.distributed as dist

    from phovo_tpu_torch.ops import _build
    from phovo_tpu_torch.parallel import distributed
    from phovo_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    kernels = dev.type == "cuda"  # a CPU rehearsal runs the plain versions, which count nothing
    inputs = mesh_inputs(I8, D16, kvo, snap)
    print(f"mesh: inputs made in {time.perf_counter() - t0:.1f} s ({len(inputs['kf']['I'])} keyframes, "
          f"{len(inputs['ba'][2])} BA observations)")
    ref = mesh_forms(inputs, make_mesh(1, devices=[dev]), dev, fb)
    for name, (_, launches, wall) in ref.items():
        print(f"mesh: {name} unsharded: {wall:.3f} s, K-GN launches {launches['K-GN']} [{card}]")
    kgn = {}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        tmp = pathlib.Path(tmp)
        check(distributed.initialize(f"file://{tmp / 'nccl'}", 1, 0, backend="nccl"), "no NCCL group was made")
        try:
            probe = torch.arange(4.0, device=dev)
            dist.all_reduce(probe)
            check(torch.equal(probe, torch.arange(4.0, device=dev)), "a one-rank NCCL all_reduce changed its input")
            one = mesh_forms(inputs, make_mesh(devices=[dev]), dev, fb)
        finally:
            dist.destroy_process_group()
        for name, (res, launches, wall) in one.items():
            bits = same_bits(res, ref[name][0])
            kgn[f"nccl 1 rank: {name}"] = launches["K-GN"]
            print(f"mesh: {name}, one rank in an NCCL group: {wall:.3f} s, the unsharded bits {bits}, K-GN launches "
                  f"{launches['K-GN']} [{card}]")
            check(bits and launches == ref[name][1], f"mesh {name}: one NCCL rank is not the unsharded call")

        ts = np.arange(CLI_FRAMES, dtype=np.float64) / 30.0
        streams = [write_raw_sequence(tmp / f"stream{k}", I8[:n], D16[:n], ts[:n], DEPTH_SCALE)
                   for k, n in enumerate(CLI_SERVE_FRAMES)]
        t0 = time.perf_counter()
        check(mesh_serve(streams, tmp / "served1", 1, dev) == 0, "phovo-serve on one process failed")
        print(f"mesh: phovo-serve --devices 1, one process: {time.perf_counter() - t0:.3f} s")
        with open(tmp / "inputs.pkl", "wb") as f:
            pickle.dump(inputs, f, protocol=pickle.HIGHEST_PROTOCOL)
        t0 = time.perf_counter()
        ranks = distributed.spawn_ranks(mesh_rank, 2, f"file://{tmp / 'gloo'}", backend="gloo",
                                        args=(str(tmp / "inputs.pkl"), [str(d) for d in streams],
                                              str(tmp / "served2"), dev.type))
        print(f"mesh: two gloo ranks on the card spawned, run and joined in {time.perf_counter() - t0:.1f} s")
        for r, (forms, rc, launches) in enumerate(ranks):
            kgn[f"gloo rank {r}: phovo-serve --devices 2"] = launches["K-GN"]
            check(rc == 0 and (launches["K-GN"] > 0 or not kernels),
                  f"phovo-serve --devices 2 on rank {r}: exit {rc}, {launches}")
            for name, (res, lc, wall) in forms.items():
                kgn[f"gloo rank {r}: {name}"] = lc["K-GN"]
                check(same_bits(res, ranks[0][0][name][0]), f"mesh {name}: rank {r} differs from rank 0")
        served = [pose_lines(tmp / "served2" / f"{d.name}.txt") == pose_lines(tmp / "served1" / f"{d.name}.txt")
                  for d in streams]
        print(f"mesh: phovo-serve --devices 2 over two gloo ranks: each stream's file the one-process file {served}, "
              f"K-GN launches by rank {[r[2]['K-GN'] for r in ranks]} [{card}]")
        check(all(served), "phovo-serve --devices 2 wrote other trajectories than one process")
    forms = ranks[0][0]
    for name, (res, launches, wall) in forms.items():
        unsharded = ref[name][0]
        counts = [r[0][name][1]["K-GN"] for r in ranks]
        if name.startswith(("dp aligner", "chunked server")):
            bits = same_bits(res, unsharded)
            apart = [(k, float(np.abs(np.asarray(a, np.float64) - b).max())) for k, (a, b) in
                     enumerate(zip(leaves(res), leaves(unsharded))) if not np.array_equal(a, b)]
            print(f"mesh: {name}, data = 2 over gloo: {wall:.3f} s on rank 0, the unsharded bits {bits}"
                  f"{f' (fields apart, max|diff|: {apart})' if apart else ''}, K-GN launches by rank {counts} "
                  f"[{card}]")
            check(bits and (all(counts) or not kernels),
                  f"mesh {name}: the data axis is not the unsharded call or launched no K-GN")
        elif name == "pixel aligner":
            err = float(np.abs(res.state - unsharded.state).max())
            cost = float(np.abs(res.cost - unsharded.cost).max() / max(np.abs(unsharded.cost).max(), 1e-30))
            same = np.array_equal(res.iterations, unsharded.iterations)
            print(f"mesh: {name}, pixel = 2 over gloo: {wall:.3f} s, max|state - unsharded| {err:.3e} (limit "
                  f"{MESH_ATOL:g}), max relative cost difference {cost:.3e}, iterations equal {same}, valid "
                  f"count difference {int(np.abs(res.num_valid - unsharded.num_valid).max())} [{card}]")
            check(err <= MESH_ATOL and same, f"mesh {name}: state difference {err}")
        elif name.startswith(("finalize", "optimize_bundle")):
            limit = MESH_ATOL
            # finalize: the keyframe poses, and the map's size (a landmark whose observation sits on the
            # occlusion gate or the image edge answers the poses' float32 noise in its validity, as on
            # the CPU against the card, phase 4g); optimize_bundle: the states and the points
            finalize = name.startswith("finalize")
            err = max_diff(res[:1] if finalize else res[:2], unsharded[:1] if finalize else unsharded[:2])
            moved = max_diff(unsharded[0], inputs["kf"]["poses"] if finalize else inputs["ba"][0])
            sizes = (len(res[1]), len(unsharded[1])) if finalize else (0, 0)
            print(f"mesh: {name}, data = 2 over gloo: {wall:.3f} s on rank 0, max|difference from the unsharded "
                  f"call| {err:.3e} (limit {limit:g}; the call moved the states by up to {moved:.3e})"
                  f"{f', map sizes {sizes}' if finalize else ''} [{card}]")
            check(err <= limit and moved > 10 * limit and sizes[0] == sizes[1],
                  f"mesh {name}: {err} from the unsharded call, map sizes {sizes}")
    return kgn


T_START = time.perf_counter()


def stamp(phase: str) -> None:
    """One line with the seconds since the script started, as a phase
    begins."""
    print(f"[{time.perf_counter() - T_START:.1f} s] {phase}", flush=True)


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
    from phovo_tpu_torch.ops import ic as IC
    from phovo_tpu_torch.ops import ic_batch as ICB
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.ops.pyramid import level_shape
    from phovo_tpu_torch.utils import trajectory as traj
    from phovo_tpu_torch.utils.config import config_from_dict
    from phovo_tpu_torch.utils.synthetic import make_sequence

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
    stamp("3. kernels vs plain")
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
        max_err = max(max_err, compare_levels(fb, pair_packs(prep), TUM_FR1, iterations, sampling, card)[0])
    tr_packs = pair_packs(prep_frame_analytic(I9, D9, TUM_FR1, cfg_tr))
    tr_err = compare_tr_levels(fb, tr_packs, TUM_FR1, cfg_tr, card)
    del prep, tr_packs

    # 3b. the loss and Jacobian variants vs plain versions
    stamp("3b. variants vs plain")
    variants = phase_variants(fb, I9, D9, card)

    # 3c. the inverse-compositional kernels vs plain versions
    stamp("3c. IC kernels vs plain")
    ic_j8_err, ic_l_err, ic_pose_err = phase_ic_kernels(I9, D9, card)
    ic_errs = phase_ic_layouts(I9, D9, card)
    ic_j8_err, ic_l_err, ic_pose_err = (max(a, b) for a, b in zip((ic_j8_err, ic_l_err, ic_pose_err), ic_errs))

    # 3d. the bi-objective level kernel vs its plain version
    stamp("3d. bi-objective kernel vs plain")
    bi_err = phase_bi_kernels(fb, I9, D9, card)

    # 3e. the shared-source modes and the multi-stream level vs plain
    stamp("3e. shared-source and multi-stream levels vs plain")
    shared_gn_err, shared_tr_err, multi_err = phase_shared(fb, fused_ops, I9, D9, card)

    # 4. the analytic main path: 257 frames through align_sequence_chunk
    stamp("4. analytic main path")
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

    # 4b. the IC main path: the same frames through align_sequence_chunk_ic
    stamp("4b. IC main path")
    (ic_pre_launches, ic_launches), ic_chain_err = phase_ic_main(run_chain, fb, se3, traj, gts, ts, card)

    # 4c. the bi-objective main path: the same frames with their depths
    stamp("4c. bi-objective main path")
    bi_launches, bi_chain_err = phase_bi_main(run_chain, fb, se3, traj, gts, ts, ate, card)

    # 4d. the keyframe main path: an out-and-back loop of VGA frames
    stamp("4d. keyframe main path")
    t0 = time.perf_counter()
    kf_frames, kf_gts = keyframe_frames(se3)
    print(f"keyframe path: rendered {len(kf_frames)} frames in {time.perf_counter() - t0:.1f} s")
    kf_out = phase_keyframe(fb, se3, traj, kf_frames, kf_gts, card)

    # 4e. serving: the 257 frames as 8 streams
    stamp("4e. serving")
    multi_launches, serve_err = phase_serving(fb, fused_ops, I8, D16, card)

    # 4f. the CLIs: the main paths as a user runs them
    stamp("4f. CLIs")
    cli = phase_cli(fb, dev, card)

    # 4g. the keyframe back-end: the bundle adjustment through phovo-vo
    stamp("4g. keyframe back-end")
    ba_trackers, ba_snaps = phase_backend(fb, traj, dev, card)

    # 4h. the iteration trace through K-LIN
    stamp("4h. iteration trace")
    trace_launches = phase_trace(fb, dev, card)

    # 4i. the port's parity harness on the cluttered scene
    stamp("4i. parity harness")
    phase_parity(dev, card)

    # 4j. the mesh forms: one NCCL rank, two gloo ranks sharing the card
    stamp("4j. mesh forms")
    mesh_launches = phase_mesh(fb, dev, card, I8, D16, ba_trackers["BA window"], ba_snaps["BA window"])

    # 5. the ceres main path: the same frames, the shipped ceres preset
    stamp("5. ceres main path")
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
    stamp("6. per-pair APIs")
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
    with mock.patch.object(autodiff, "fused_tr_level_batch", fb.fused_tr_level_batch_reference):
        warm_plain = autodiff.align_sequence_autodiff(Iapi, Dapi, TUM_FR1, cfg_tr, warm_start=True)
    check(fb.TR_LAUNCHES == warm_launches, "the plain warm run launched the kernel")
    err, _ = compare_tr_results(
        warm, warm_plain, f"warm start: {N_API_PAIRS} pairs kernel vs plain [{card}]", strict=False,
    )
    tr_err = max(tr_err, err)

    # 6b-6d. the per-pair analytic API, the occluded pair, the
    # per-linearization API
    an_launches, an_err = phase_analytic_api(fb, I8, D16, card)
    phase_occlusion(fb, card)
    lin_launches = phase_linearizer(fb, I8, D16, card)
    # 6e. the IC object API
    ic_api_launches, ic_api_err = phase_ic_api(I8, D16, card)
    # 6f. the bi-objective object API
    stamp("6f. bi-objective object API")
    bi_api_launches, bi_api_err = phase_bi_api(fb, I8, D16, card)
    # 6g. the ceres backend's jacfwd Jacobian
    stamp("6g. jacfwd")
    phase_jacfwd(dev, card)

    # 7. timing, device-resident frames: the bench.py workload
    stamp("7. timing")
    Is, Ds = timing_frames(dev)
    n_pairs = N_FRAMES - 1
    ms_fixed = cuda_ms(lambda: align_sequence(Is, Ds, TUM_FR1, cfg_fixed), REPEATS)
    ms_ee = cuda_ms(lambda: align_sequence(Is, Ds, TUM_FR1, cfg_ee), REPEATS)
    print(f"bench workload fixed-75: {1e3 * n_pairs / ms_fixed:.1f} frames/s ({ms_fixed:.3f} ms / {n_pairs} pairs) [{card}]")
    print(f"bench workload early exit: {1e3 * n_pairs / ms_ee:.1f} pairs/s ({ms_ee:.3f} ms / {n_pairs} pairs) [{card}]")

    ms_prep = cuda_ms(lambda: prep_frame_analytic(Is, Ds, TUM_FR1, cfg_fixed), REPEATS)
    print(f"layer prep (pyramids, Scharr, packs of {N_FRAMES} frames): {ms_prep:.3f} ms [{card}]")
    packs = pair_packs(prep_frame_analytic(Is, Ds, TUM_FR1, cfg_fixed))
    kernel_ms = plain_ms = gn_bytes = gn_flops = 0.0
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
        res = fb.fused_gn_level_batch(*args, **kw)
        gn_bytes += nbytes(i0, geom, t_all, args[4], *res)
        gn_flops += float(res.iterations.double().sum()) * H * W * GN_FLOPS["nearest"]
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
    tr_kernel_ms = tr_plain_ms = tr_bytes = tr_flops = 0.0
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
        # one linearization at the start and one a trial step
        tr_bytes += nbytes(i0, geom, t_all, init, *res)
        tr_flops += float(n_pairs + res.iterations.double().sum()) * H * W * GN_FLOPS[cfg_tr.sampling]
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
    init1 = torch.zeros((1, 6), device=dev)
    tr1 = (*one, TUM_FR1, init1, cfg_tr.trust_region_options(0))
    tr1_kw = dict(H=SHAPE[0], W=SHAPE[1])
    p1 = cuda_ms(lambda: fb.fused_tr_level_batch_reference(*tr1, **tr1_kw), 3)
    k1 = cuda_ms(lambda: fb.fused_tr_level_batch(*tr1, **tr1_kw), 3)
    k2 = cuda_ms(lambda: fb.fused_tr_level_batch(*tr1, **tr1_kw), 3)
    p2 = cuda_ms(lambda: fb.fused_tr_level_batch_reference(*tr1, **tr1_kw), 3)
    one_tr = fb.fused_tr_level_batch(*tr1, **tr1_kw)
    one_tr_bound = bound(nbytes(*one, init1, *one_tr),
                         float(1 + one_tr.iterations.double().sum()) * SHAPE[0] * SHAPE[1] * GN_FLOPS[cfg_tr.sampling])
    print(f"per-pair route: align_autodiff {ms_pair:.3f} ms a VGA pair; its 480x640 level "
          f"(B = 1, {fb.cluster_size(*SHAPE)} blocks, {int(one_tr.iterations.sum())} iterations): kernel "
          f"{(k1 + k2) / 2:.3f} ms ({k1:.3f}, {k2:.3f}), plain {(p1 + p2) / 2:.3f} ms ({p1:.3f}, {p2:.3f}), bound "
          f"{one_tr_bound[0]:.4f} ms ({one_tr_bound[1]}) [{card}]")

    # 7b. this slice's paths: the per-pair analytic route, the analytic
    # chain with each variant, the ceres chain with huber, the
    # one-linearization kernel at 480x640
    cfg_an = config_from_dict(ANALYTIC_PRESET)
    zero6 = torch.zeros(6, device=dev)
    ms_an = cuda_ms(lambda: analytic.align_analytic(Is[0], Ds[0], Is[1], Ds[1], TUM_FR1, zero6, cfg_an), REPEATS)
    print(f"per-pair analytic route: align_analytic {ms_an:.3f} ms a VGA pair (analytic preset, "
          f"one K-PREP launch and 3 K-GN launches at B = 1) [{card}]")
    for variant in ("none", "huber", "tdist", "esm"):
        cfg = variant_config(cfg_ee, variant)
        ms = cuda_ms(lambda: align_sequence(Is, Ds, TUM_FR1, cfg), REPEATS)
        print(f"analytic chain {variant}, early exit at 300: {1e3 * n_pairs / ms:.1f} pairs/s "
              f"({ms:.3f} ms / {n_pairs} pairs) [{card}]")
    cfg = variant_config(cfg_tr, "huber")
    ms = cuda_ms(lambda: autodiff.align_sequence_autodiff(Is, Ds, TUM_FR1, cfg), 3)
    print(f"ceres chain huber: {1e3 * n_pairs / ms:.1f} pairs/s ({ms:.3f} ms / {n_pairs} pairs) [{card}]")
    gn1 = (*one, TUM_FR1, torch.zeros((1, 6), device=dev), NEAREST_ITERATIONS, 0.0, 1.0)
    gn1_kw = dict(H=SHAPE[0], W=SHAPE[1], sampling="nearest")
    p1 = cuda_ms(lambda: fb.fused_gn_level_batch_reference(*gn1, **gn1_kw), 3)
    k1 = cuda_ms(lambda: fb.fused_gn_level_batch(*gn1, **gn1_kw), REPEATS)
    k2 = cuda_ms(lambda: fb.fused_gn_level_batch(*gn1, **gn1_kw), REPEATS)
    p2 = cuda_ms(lambda: fb.fused_gn_level_batch_reference(*gn1, **gn1_kw), 3)
    gn1_bound = bound(nbytes(*gn1[:3], gn1[4], *fb.fused_gn_level_batch(*gn1, **gn1_kw)),
                      NEAREST_ITERATIONS * SHAPE[0] * SHAPE[1] * GN_FLOPS["nearest"])
    print(f"layer GN level kernel at B = 1 (the per-pair level): {SHAPE[0]}x{SHAPE[1]}, {NEAREST_ITERATIONS} nearest "
          f"iterations, {fb.cluster_size(*SHAPE)} blocks: kernel {(k1 + k2) / 2:.3f} ms ({k1:.3f}, {k2:.3f}), plain "
          f"{(p1 + p2) / 2:.3f} ms ({p1:.3f}, {p2:.3f}), bound {gn1_bound[0]:.4f} ms ({gn1_bound[1]}) [{card}]")
    lin_rows = phase_lin_timing(fb, dev, card)
    lin_ms, lin_plain_ms, lin_bound, _ = lin_rows[1, 0]

    # 7c. the IC chain, its prep and its kernels
    stamp("7c. IC timing")
    ic_rec = phase_ic_timing(Is, Ds, card)
    # 7d. the bi-objective chain, its prep and its kernel
    stamp("7d. bi-objective timing")
    bi_rec = phase_bi_timing(Is, Ds, card)
    # 7e. the keyframe path, serving and this slice's kernels
    stamp("7e. keyframe and serving timing")
    del Is, Ds
    kf_rec = phase_keyframe_serving_timing(fb, fused_ops, kf_frames, I8, D16, card)
    # 7f. the cluster layout of K-TR and K-GN against one block a pair
    stamp("7f. cluster layout timing")
    phase_cluster_timing(kf_frames[:KF_CHUNK + 1], dev, card)
    # 7g. the keyframe back-end's times
    stamp("7g. back-end timing")
    phase_backend_timing(dev, ba_trackers, ba_snaps, card)
    # 7h. launches and host share of a serving step and an LM iteration
    stamp("7h. profiles")
    phase_profiles(dev, I8, D16, ba_trackers, ba_snaps, card)
    # 7i. K-PREP against the torch chain, and the main paths' launches
    stamp("7i. K-PREP")
    prep_rec = phase_prep(I8, D16, dev, card)
    stamp("done")

    gn_bound, tr_bound = bound(gn_bytes, gn_flops), bound(tr_bytes, tr_flops)
    # blocks a pair by level of each row's timed work (1: one block a pair,
    # the kernels without a cluster layout)
    bench_levels = [lv for lv, n in enumerate(cfg_fixed.max_iterations) if n > 0]
    an_levels = [lv for lv, n in enumerate(config_from_dict(ANALYTIC_PRESET).max_iterations) if n > 0]
    record = {"kernels": [
        {
            "name": "fused_gn_level_batch",
            "route": "cuda",
            "source": "phovo_tpu_torch/csrc/fused_gn_batch.cu",
            "replaces": "phovo_tpu/ops/fused_batch.py:607 and phovo_tpu/ops/fused.py:1103",
            "launches": launches,
            "max_abs_err": max(max_err, an_err, variants["fused_gn_level_batch"][0]),
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": gn_bound[0],
            "bound_by": gn_bound[1],
            "library_ms": None,
            "variants": variants["fused_gn_level_batch"][1],
            "per_pair_launches": an_launches,
            "mesh_launches": mesh_launches,
            "cluster": level_clusters(bench_levels),
        },
        {
            "name": "fused_tr_level_batch",
            "route": "cuda",
            "source": "phovo_tpu_torch/csrc/fused_tr_batch.cu",
            "replaces": "phovo_tpu/ops/fused_batch.py:922 and phovo_tpu/ops/fused.py:1011",
            "launches": tr_launches,
            "max_abs_err": max(tr_err, variants["fused_tr_level_batch"][0]),
            "ms": tr_kernel_ms,
            "plain_ms": tr_plain_ms,
            "bound_ms": tr_bound[0],
            "bound_by": tr_bound[1],
            "library_ms": None,
            "variants": variants["fused_tr_level_batch"][1],
            "cluster": level_clusters(range(5)),
        },
        {
            "name": "fused_lin",
            "route": "cuda",
            "source": "phovo_tpu_torch/csrc/fused_lin.cu",
            "replaces": "phovo_tpu/ops/fused.py:735",
            "launches": lin_launches,
            "max_abs_err": variants["fused_lin"][0],
            "ms": lin_ms,
            "plain_ms": lin_plain_ms,
            "bound_ms": lin_bound[0],
            "bound_by": lin_bound[1],
            "library_ms": None,
            "variants": variants["fused_lin"][1],
            "split": level_clusters(range(5), fb.lin_split),
            "trace_launches": trace_launches,
            "by_level": {f"B = {B}, level {lv}": {"ms": r[0], "plain_ms": r[1], "bound_ms": r[2][0],
                                                   "wrapper_ms": r[3]}
                         for (B, lv), r in lin_rows.items()},
        },
        {
            "name": "ic_precompute",
            "route": "cuda",
            "source": "phovo_tpu_torch/csrc/ic_precompute.cu",
            "replaces": "phovo_tpu/ops/ic.py:517",
            "launches": ic_pre_launches,
            "max_abs_err": ic_j8_err,
            "factor_rel_err": ic_l_err,
            **ic_rec["ic_precompute"],
            "library_ms": None,
            "cluster": level_clusters(range(5), IC.ic_precompute_cluster_size),
        },
        {
            "name": "ic_gn_level_batch",
            "route": "cuda",
            "source": "phovo_tpu_torch/csrc/ic_gn_batch.cu",
            "replaces": "phovo_tpu/ops/ic.py:156 and phovo_tpu/ops/ic_batch.py:78",
            "launches": ic_launches,
            "max_abs_err": max(ic_pose_err, ic_chain_err, ic_api_err),
            **ic_rec["ic_gn_level_batch"],
            "library_ms": None,
            "per_pair_launches": ic_api_launches,
            "cluster": level_clusters(range(5), ICB.ic_cluster_size),
            "resident": level_clusters(range(5), lambda H, W: ICB.ic_resident(H, W, ICB.ic_cluster_size(H, W))),
        },
        {
            "name": "fused_gn_level_batch_bi",
            "route": "cuda",
            "source": "phovo_tpu_torch/csrc/fused_gn_batch.cu",
            "replaces": "phovo_tpu/ops/fused_batch.py:607 (bi) and phovo_tpu/ops/fused.py:1162",
            "launches": bi_launches,
            "max_abs_err": max(bi_err, bi_chain_err, bi_api_err),
            **bi_rec,
            "library_ms": None,
            "variants": list(BI_LOSSES),
            "per_pair_launches": bi_api_launches,
            "cluster": level_clusters(bench_levels),
        },
        {
            "name": "fused_gn_level_batch_shared",
            "route": "cuda",
            "source": "phovo_tpu_torch/csrc/fused_gn_batch.cu",
            "replaces": "phovo_tpu/ops/fused_batch.py:607 (shared_src, wrapper :711)",
            "launches": kf_out["analytic"][0],
            "max_abs_err": max(shared_gn_err, kf_out["analytic"][1]),
            **kf_rec["fused_gn_level_batch_shared"],
            "library_ms": None,
            "variants": list(SHARED_VARIANTS),
            "cluster": level_clusters(an_levels),
        },
        {
            "name": "fused_tr_level_batch_shared",
            "route": "cuda",
            "source": "phovo_tpu_torch/csrc/fused_tr_batch.cu",
            "replaces": "phovo_tpu/ops/fused_batch.py:922 (shared_src, wrapper :1087)",
            "launches": kf_out["ceres"][0],
            "max_abs_err": max(shared_tr_err, kf_out["ceres"][1]),
            **kf_rec["fused_tr_level_batch_shared"],
            "library_ms": None,
            "cluster": level_clusters(range(5)),
        },
        {
            "name": "fused_gn_level_multi",
            "route": "cuda",
            "source": "phovo_tpu_torch/csrc/fused_gn_batch.cu",
            "replaces": "phovo_tpu/ops/fused.py:1405",
            "launches": multi_launches,
            "max_abs_err": max(multi_err, serve_err),
            **kf_rec["fused_gn_level_multi"],
            "library_ms": None,
            "cluster": level_clusters(an_levels),
        },
        {
            "name": "prep_levels",
            "route": "cuda",
            "source": "phovo_tpu_torch/csrc/prep_levels.cu",
            "replaces": None,
            "launches": 1,
            "max_abs_err": 0.0,
            **prep_rec["by_chunk"]["ceres"],
            "library_ms": None,
            "by_chunk": prep_rec["by_chunk"],
            "main_path_launches": prep_rec["main_path_launches"],
        },
    ]}
    # each kernel's launches under each CLI run that launched it
    counters = {"fused_gn_level_batch": "K-GN", "fused_tr_level_batch": "K-TR", "fused_lin": "K-LIN",
                "ic_precompute": "K-ICpre", "ic_gn_level_batch": "K-IC", "fused_gn_level_batch_bi": "K-GN",
                "fused_gn_level_batch_shared": "K-GN shared", "fused_tr_level_batch_shared": "K-TR shared",
                "fused_gn_level_multi": None, "prep_levels": None}
    for entry in record["kernels"]:
        key = counters[entry["name"]]
        bi = entry["name"].endswith("_bi")
        entry["cli_launches"] = {run: c[key] for run, c in cli.items()
                                 if key and c[key] and ("biobjective" in run) == bi}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
