"""Analytic Gauss-Newton backend (torch port of phovo_tpu/models/analytic.py).

Routing follows phovo_tpu, without its TPU-only limits (no height cap, no
band). Every route of the level kernel (gradient_at 'warped' or 'esm',
use_fused) is one loop, align_pairs_levelmajor: per active level, coarse
to fine, one launch of K-GN for a batch of pairs from their packs (the
prep layer's, ops/prep.py: one K-PREP launch on the card where it takes
the frames). A single pair, a warm chain and a tracked chunk are batches
of it:
  * per pair, align_analytic preps the pair (ops/prep.prep_pair) and runs
    the loop at B = 1;
  * gradient_at='source' and use_fused=False run the exact torch path,
    gauss_newton_level over photometric_residual_jacobian +
    normal_equations, as phovo_tpu runs them through XLA;
  * keyframe tracking (models/keyframe.py run_chunked) runs a chunk of
    frames against one keyframe level-major, with the keyframe's packs
    shared by every pair (track_chunk_levelmajor) from explicit per-pair
    inits, or as the serial warm-started scan of align_analytic
    (track_sequence_chunk); Student-t chunks always take the scan, as
    phovo_tpu's gate sends them (track_levelmajor_eligible);
  * S independent pairs of a shared rig run the loop through the
    multi-stream wrapper (align_batch_fused, phovo_tpu's B7 route);
  * frame chains from zero (the reference's pair semantics,
    PhotoconsistencyVisualOdometry.cpp:224) run level-major: the pairs are
    independent, so all pairs' coarsest level runs in one launch, then all
    pairs' next level, and so on; every loss does, tdist too (its scale is a
    per-pair scalar in the kernel). warm_start runs the serial chain of
    align_prepped, the loop at B = 1 a pair, over per-frame packs computed
    once: each frame serves as the target of one pair and the source of
    the next.
robust_loss='tdist': the scale sigma seeds from robust_delta, runs
TDIST_BURNIN scale-only passes at the first active level, and passes to
the next active level as tdist_scale_update(cost, num_valid) of the level
before; skipped levels leave it alone (phovo_tpu/models/analytic.py:
104-180).
"""

from __future__ import annotations

import numpy as np
import torch

from phovo_tpu_torch.models.base import (
    DEFAULT_DEVICE,
    AlignmentResult,
    PhotoconsistencyOdometryBase,
    prepped_chain,
    sequence_scan,
    stack_levels,
)
from phovo_tpu_torch.ops import pyramid as pyr
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.fused import fused_gn_level_multi_packs
from phovo_tpu_torch.ops.fused_batch import fused_gn_level_batch
from phovo_tpu_torch.ops.prep import chunk_device_prep, device_unit_intensity, prep_chunk, prep_pair
from phovo_tpu_torch.ops.prep import prep_frames as prep_frame_analytic
from phovo_tpu_torch.ops.prep import prep_targets as prep_frame_targets
from phovo_tpu_torch.ops.residuals import normal_equations, photometric_residual_jacobian
from phovo_tpu_torch.ops.robust import TDIST_BURNIN, tdist_scale_update
from phovo_tpu_torch.solvers.gauss_newton import gauss_newton_level
from phovo_tpu_torch.utils import profiling
from phovo_tpu_torch.utils.config import PhovoConfig


def _fused_route(config: PhovoConfig, use_fused: bool) -> bool:
    """True when the level kernel runs: every level size on the GPU."""
    return use_fused and config.gradient_at in ("warped", "esm")


def _coarse_to_fine(run_level, state: torch.Tensor, config: PhovoConfig) -> AlignmentResult:
    """Run the active levels coarse to fine from state ((6,) for one pair,
    (B, 6) for B pairs). run_level(level, state, sigma, burnin) -> (state,
    iterations, gradient_norm, cost, num_valid) of that level; sigma is the
    Student-t scale for 'tdist' (None otherwise) and burnin its scale-only
    passes. Skipped levels leave the state and report zeros."""
    tdist = config.robust_loss == "tdist"
    zero = torch.zeros(state.shape[:-1], dtype=torch.float32, device=state.device)
    sigma = torch.full_like(zero, config.robust_delta) if tdist else None
    burnin = TDIST_BURNIN if tdist else 0
    diags = [(zero,) * 5] * config.num_levels
    for level in range(config.num_levels - 1, -1, -1):
        if config.max_iterations[level] <= 0:
            continue
        state, its, gnorm, cost, nvalid = run_level(level, state, sigma, burnin)
        diags[level] = (its.to(torch.float32), gnorm, cost, nvalid, zero)
        if tdist:
            sigma = tdist_scale_update(cost, nvalid)
        burnin = 0
    return stack_levels(state, diags)


def _gn_options(config: PhovoConfig, level: int):
    return (
        config.max_iterations[level], config.min_gradient_norms[level],
        config.lambda_steps[level],
    )


def align_analytic(
    source_intensity: torch.Tensor,  # (H, W) uint8 or float32 0..1
    source_depth: torch.Tensor,  # (H, W) metres
    target_intensity: torch.Tensor,  # (H, W)
    target_depth: torch.Tensor,  # unused (the reference SetTargetFrame ignores depth)
    intr: Intrinsics,
    init_state: torch.Tensor,  # (6,)
    config: PhovoConfig,
    use_fused: bool = True,
) -> AlignmentResult:
    """Align one pair coarse to fine on the device the tensors live on: the
    pair's packs of every active level at once (ops/prep.prep_pair, one
    K-PREP launch on the card where it takes the frames), then
    align_pairs_levelmajor at B = 1, one level-kernel launch per active
    level; or the exact torch path for gradient_at='source' and
    use_fused=False."""
    del target_depth
    if _fused_route(config, use_fused):
        packs = prep_pair(source_intensity, source_depth, target_intensity, intr, config)
        return _align_one(packs, tuple(source_intensity.shape[-2:]), intr, config, init_state)
    si = device_unit_intensity(source_intensity).to(torch.float32)
    ti = device_unit_intensity(target_intensity).to(torch.float32)
    L, blur, scales = config.num_levels, config.blur_filter_sizes, config.gradient_scales
    int0 = pyr.build_pyramid(si, L, blur, blur_type=config.blur_type)
    dep0 = pyr.build_pyramid(source_depth.to(device=si.device, dtype=torch.float32), L)
    int1 = pyr.build_pyramid(ti, L, blur, blur_type=config.blur_type)
    gx1, gy1 = pyr.build_gradient_pyramid(int1, scales)
    esm = config.gradient_at == "esm"
    if esm:  # the source gradients of the ESM Jacobian
        gx0, gy0 = pyr.build_gradient_pyramid(int0, scales)

    def run_level(level, state, sigma, burnin):
        intr_l = intr.at_level(level)
        sg = (gx0[level], gy0[level]) if esm else None

        def linearize(s, *scale):
            r, J, valid = photometric_residual_jacobian(
                int0[level], dep0[level], int1[level], gx1[level], gy1[level], s,
                intr_l, min_depth=config.min_depth, max_depth=config.max_depth,
                sampling=config.sampling, gradient_at=config.gradient_at,
                source_grad_x=sg[0] if esm else None,
                source_grad_y=sg[1] if esm else None,
            )
            return normal_equations(
                r, J, valid, config.robust_loss, scale[0] if scale else config.robust_delta
            )

        res = gauss_newton_level(
            linearize, state, *_gn_options(config, level),
            adaptive_scale=sigma, adaptive_burnin=burnin,
        )
        its = torch.tensor(float(res.iterations), device=state.device)
        return res.state, its, res.gradient_norm, res.cost, res.num_valid

    state = init_state.to(device=si.device, dtype=torch.float32)
    return _coarse_to_fine(run_level, state, config)


def prep_keyframe(
    intensity: torch.Tensor,  # (H, W) uint8 or float32 0..1
    depth: torch.Tensor,  # (H, W) float32 metres
    intr: Intrinsics,
    config: PhovoConfig,
) -> dict:
    """The source packs of ONE keyframe, computed once at promotion and
    shared by every tracked chunk until the next: level -> (i0 (1, H*W),
    geom (1, 4 | 6, H*W)), the shared-source layout of the level kernels."""
    full = prep_frame_analytic(intensity[None], depth[None], intr, config)
    return {level: (i0, geom) for level, (i0, geom, _) in full.items()}


def track_sequence_chunk(
    kf_intensity: torch.Tensor,  # (H, W) the keyframe (the source)
    kf_depth: torch.Tensor,  # (H, W) metres
    intensities: torch.Tensor,  # (B, H, W) frames to track, uint8 or float32
    depths: torch.Tensor,  # (B, H, W) metres float32, or raw counts
    intr: Intrinsics,
    init_state: torch.Tensor,  # (6,) the first frame's init
    config: PhovoConfig,
    use_fused: bool = True,
    depth_scale: float | None = None,
) -> AlignmentResult:
    """Track B frames against ONE keyframe in series (phovo_tpu/models/
    analytic.py::track_sequence_chunk, warm-started): frame k aligns the
    keyframe to it with align_analytic (the pair's prep, then one K-GN
    launch at B = 1 per active level) from the state the frame before
    ended at, the first frame from init_state. depth_scale converts raw
    depth counts on the device. Results have leading dim B."""
    if depth_scale is not None and depths.dtype != torch.float32:
        depths = depths.to(torch.float32) * float(np.float32(depth_scale))
    kf_i = device_unit_intensity(kf_intensity).to(torch.float32)
    kf_d = kf_depth.to(torch.float32)
    state = init_state.to(device=kf_i.device, dtype=torch.float32)
    results = []
    for ti, td in zip(intensities, depths):
        res = align_analytic(kf_i, kf_d, ti, td, intr, state, config, use_fused)
        results.append(res)
        state = res.state
    return AlignmentResult(*(torch.stack(x) for x in zip(*results)))


def track_levelmajor_eligible(config: PhovoConfig, use_fused: bool = True) -> bool:
    """True when a keyframe chunk can run level-major: the level kernel's
    route (gradient_at 'warped' or 'esm', use_fused) and any loss but
    'tdist', which phovo_tpu's gate (analytic.py:768) sends to the serial
    scan and so does this one. There is no tiling gate: every level size
    runs on the GPU."""
    return _fused_route(config, use_fused) and config.robust_loss != "tdist"


def track_pairs_levelmajor(
    kf_prep: dict,  # prep_keyframe: level -> (i0 (1, N), geom (1, GR, N))
    tgt_targets: dict,  # level -> t_all (B, 3, H, W), prep_frame_targets
    shape: tuple[int, int],
    intr: Intrinsics,
    config: PhovoConfig,
    init_states: torch.Tensor,  # (B, 6) explicit per-pair inits
) -> AlignmentResult:
    """B frames tracked against ONE keyframe, level-major: per active level
    one launch of the level kernel with the keyframe's packs shared by
    every pair (phovo_tpu/models/analytic.py::track_pairs_levelmajor), by
    align_pairs_levelmajor. Each pair starts from its own init state."""
    packs = {level: (*src, tgt_targets[level]) for level, src in kf_prep.items()}
    return align_pairs_levelmajor(packs, shape, intr, config, init_states.to(torch.float32))


def track_chunk_levelmajor(
    kf_prep: dict,
    intensities: torch.Tensor,  # (B, H, W) frames to track, uint8 or float32
    intr: Intrinsics,
    init_states: torch.Tensor,  # (B, 6)
    config: PhovoConfig,
) -> AlignmentResult:
    """Track a chunk of B frames against ONE keyframe, level-major
    (phovo_tpu/models/analytic.py::track_chunk_levelmajor): the frames
    are prepped as targets only, then track_pairs_levelmajor."""
    tgt = prep_frame_targets(intensities, config)
    return track_pairs_levelmajor(
        kf_prep, tgt, tuple(intensities.shape[1:]), intr, config, init_states
    )


def multi_kernel_eligible(config: PhovoConfig) -> bool:
    """True when align_batch_fused takes the config: any loss but 'tdist'
    (phovo_tpu/models/analytic.py:877; the GPU has no VMEM or height cap
    to gate on)."""
    return config.robust_loss != "tdist"


def align_batch_fused(
    source_intensity: torch.Tensor,  # (S, H, W) uint8 or float32 0..1
    source_depth: torch.Tensor,  # (S, H, W) metres
    target_intensity: torch.Tensor,  # (S, H, W)
    target_depth: torch.Tensor,  # unused (the reference SetTargetFrame ignores depth)
    intr: Intrinsics,  # shared by the streams
    init_states: torch.Tensor,  # (S, 6)
    config: PhovoConfig,
) -> AlignmentResult:
    """S independent alignments advanced by ONE multi-stream level per
    active level (phovo_tpu/models/analytic.py::align_batch_fused). The
    frames are prepped as parallel.batch.align_batch preps them (sources
    by prep_frame_analytic, targets by prep_frame_targets); on the GPU
    there is no VMEM choice between the batched and the multi-stream
    kernel, so every level goes through ops/fused.fused_gn_level_multi_packs
    (the B7 route, K-GN at B = S). 'tdist' raises ValueError. Returns
    batched results (leading dim S)."""
    del target_depth
    si = device_unit_intensity(source_intensity).to(torch.float32).contiguous()
    ti = device_unit_intensity(target_intensity).to(torch.float32)
    src = prep_frame_analytic(si, source_depth.to(device=si.device, dtype=torch.float32), intr, config)
    tgt = prep_frame_targets(ti, config)
    packs = {level: (i0, geom, tgt[level]) for level, (i0, geom, _) in src.items()}
    states = init_states.to(device=si.device, dtype=torch.float32).reshape(-1, 6)
    return align_pairs_levelmajor(packs, tuple(si.shape[1:]), intr, config, states, multi=True)


def align_prepped(
    src: dict,  # prep_frame_analytic of the source frame (no frame dim)
    tgt: dict,  # prep_frame_analytic of the target frame
    shape: tuple[int, int],
    intr: Intrinsics,
    init_state: torch.Tensor,  # (6,)
    config: PhovoConfig,
) -> AlignmentResult:
    """Align one pair from per-frame packs: the source's i0 and geom and the
    target's t_all (with the bi-objective products, its t6 and gain) given
    a batch axis of 1, through align_pairs_levelmajor. The same kernel and
    numbers as align_analytic, with the packs computed once per frame
    instead of per pair."""
    packs = {level: tuple(x[None] for x in (*src[level][:2], *tgt[level][2:])) for level in src}
    return _align_one(packs, shape, intr, config, init_state)


def _align_one(packs: dict, shape, intr: Intrinsics, config: PhovoConfig, init_state: torch.Tensor) -> AlignmentResult:
    """One pair as a batch of one: align_pairs_levelmajor on packs with a
    batch axis of 1 from init_state (6,); the result without the batch
    axis."""
    state = init_state.to(device=next(iter(packs.values()))[0].device, dtype=torch.float32).reshape(1, 6)
    return AlignmentResult(*(x[0] for x in align_pairs_levelmajor(packs, shape, intr, config, state)))


def align_sequence_prepped(
    intensities: torch.Tensor,  # (B+1, H, W) float32 0..1 or uint8
    depths: torch.Tensor,  # (B+1, H, W) float32 metres
    intr: Intrinsics,
    config: PhovoConfig,
) -> AlignmentResult:
    """The warm-started chain: the pairs in series over per-frame packs
    computed once, in one batched pass; pair k aligns frame k to frame k+1
    from the state pair k-1 ended at (pair 0 from zero). Chains from zero
    run level-major (align_sequence_levelmajor)."""
    prep = prep_frame_analytic(intensities, depths, intr, config)
    shape = tuple(intensities.shape[1:])
    return prepped_chain(
        prep, intensities.shape[0] - 1,
        lambda src, tgt, init: align_prepped(src, tgt, shape, intr, init, config),
        intensities.device,
    )


def align_pairs_levelmajor(
    prep_pairs: dict,
    shape: tuple[int, int],
    intr: Intrinsics,
    config: PhovoConfig,
    init_states: torch.Tensor | None = None,  # (B, 6); zeros when None
    multi: bool = False,
) -> AlignmentResult:
    """Level-major alignment of B independent pairs from per-pair packs
    (level -> (i0 (B | 1, N), geom (B | 1, 4 | 6, N), t_all (B, 3, H, W))
    for every active level, a source pack of batch 1 shared by every pair;
    or the bi-objective (i0, geom, t6 (B, 6, H, W), gains (B,)), which run
    K-GN-bi), each from its init state (the zero state by default); the
    Student-t scale is carried per pair. The one loop of the analytic and
    bi-objective kernel routes: a single pair and a warm chain's pair are
    batches of one. multi launches each level through the multi-stream
    wrapper (align_batch_fused's B7 route), the same kernel counted as
    such. Returns batched results: state (B, 6), per-level diagnostics (B,
    L)."""
    i0_any = next(iter(prep_pairs.values()))[0]
    esm = config.gradient_at == "esm"

    def run_level(level, states, sigma, burnin):
        H, W = pyr.level_shape(shape, level)
        i0, geom, t_all, *gains = prep_pairs[level]
        res = (fused_gn_level_multi_packs if multi else fused_gn_level_batch)(
            i0, geom, t_all, intr.at_level(level), states,
            *_gn_options(config, level), H=H, W=W, sampling=config.sampling,
            robust_loss=config.robust_loss, robust_delta=config.robust_delta,
            esm=esm, robust_scale=sigma, tdist_burnin=burnin,
            depth_gains=gains[0] if gains else None,
        )
        return res[:5]

    if init_states is None:
        init_states = torch.zeros((i0_any.shape[0], 6), dtype=torch.float32, device=i0_any.device)
    return _coarse_to_fine(run_level, init_states.contiguous(), config)


def align_sequence_levelmajor(
    intensities: torch.Tensor,  # (B+1, H, W) float32 0..1 or uint8
    depths: torch.Tensor,  # (B+1, H, W) float32 metres
    intr: Intrinsics,
    config: PhovoConfig,
) -> AlignmentResult:
    """align_sequence ordered level-major: each frame prepped once, pair k
    aligns frame k (source) to frame k+1 (target)."""
    prep = prep_frame_analytic(intensities, depths, intr, config)
    return align_pairs_levelmajor(_chain_pairs(prep), tuple(intensities.shape[1:]), intr, config)


def _chain_pairs(prep: dict) -> dict:
    """The pairs' packs of a chain's per-frame packs: pair k is frame k's
    source pack (i0, geom) and frame k+1's target products (t_all; the
    bi-objective t6 and gain)."""
    return {level: (i0[:-1], geom[:-1], *(x[1:] for x in tgt)) for level, (i0, geom, *tgt) in prep.items()}


def align_sequence(
    intensities: torch.Tensor,  # (B+1, H, W) consecutive frames
    depths: torch.Tensor,  # (B+1, H, W)
    intr: Intrinsics,
    config: PhovoConfig,
    use_fused: bool = True,
    warm_start: bool = False,
) -> AlignmentResult:
    """Align all consecutive pairs of a buffered frame sequence: results
    have leading dim B (pair k aligns frame k -> k+1). Runs on the device
    the tensors live on: the CUDA level kernel for CUDA tensors, its plain
    torch version for CPU tensors. Level-major from zero; a serial chain
    with warm_start; the exact torch path, pair after pair, where the
    kernel does not run (gradient_at='source', use_fused=False)."""
    if not _fused_route(config, use_fused):
        return sequence_scan(
            lambda si, sd, ti, td, init: align_analytic(si, sd, ti, td, intr, init, config, use_fused),
            intensities, depths, warm_start,
        )
    if warm_start:
        return align_sequence_prepped(intensities, depths, intr, config)
    return align_sequence_levelmajor(intensities, depths, intr, config)


def align_sequence_chunk(
    carry_intensity: torch.Tensor,  # (H, W) last frame of the previous chunk
    carry_depth: torch.Tensor,  # (H, W)
    intensities: torch.Tensor,  # (B, H, W) new frames, uint8 or float32
    depths: torch.Tensor,  # (B, H, W) metres float32, or raw counts
    intr: Intrinsics,
    config: PhovoConfig,
    use_fused: bool = True,
    warm_start: bool = False,
    depth_scale: float | None = None,
) -> tuple[AlignmentResult, torch.Tensor, torch.Tensor]:
    """Streaming variant of align_sequence for the chunked VO pipeline:
    the carry frame stays on the device and the chunk is prepended there,
    so per chunk the host moves only the new frames in storage dtype.
    From zero on the level kernel's route the pairs' packs come straight
    from the carry and the storage-dtype frames (ops/prep.prep_chunk).
    warm_start chains the chunk's pairs; its first pair starts from zero,
    as phovo_tpu's does. Returns (results over B pairs, new carry
    intensity, new carry depth), the carries already converted to
    float32."""
    with profiling.span("phovo.align"):
        if not warm_start and _fused_route(config, use_fused):
            packs, ci, cd = prep_chunk(carry_intensity, carry_depth, intensities, depths, depth_scale, intr, config)
            return align_pairs_levelmajor(packs, tuple(intensities.shape[1:]), intr, config), ci, cd
        I, D = chunk_device_prep(
            carry_intensity, carry_depth, intensities, depths, depth_scale
        )
        return align_sequence(I, D, intr, config, use_fused, warm_start), I[-1], D[-1]


class PhotoconsistencyOdometryAnalytic(PhotoconsistencyOdometryBase):
    """Object API over align_analytic (reference class
    CPhotoconsistencyOdometryAnalytic, ...Analytic.h:57)."""

    def __init__(self, config: PhovoConfig | None = None, use_fused: bool = True, device=DEFAULT_DEVICE):
        super().__init__(config, device)
        self.use_fused = use_fused

    def align(self, si, sd, ti, td, intr, init_state) -> AlignmentResult:
        return align_analytic(si, sd, ti, td, intr, init_state, self.config, self.use_fused)

    def align_full_band(self, si, sd, ti, td, intr, init_state) -> AlignmentResult:
        """The exact torch path (phovo_tpu's band fallback re-runs a pair
        there; the GPU kernel has no band, so nothing calls it here)."""
        return align_analytic(si, sd, ti, td, intr, init_state, self.config, use_fused=False)
