"""Trust-region ("ceres") backend (torch port of phovo_tpu/models/autodiff.py).

The reference's Ceres functor bilinear-samples the target and its Scharr
gradients at the warped point and chains them through forward-mode autodiff
(third_party/sample.h:104-123): that is the analytic linearization with
bilinear sampling and the gradient taken at the warped point. So this
backend runs the same per-pixel linearization as the analytic chain, under
a Ceres-schema trust-region Levenberg-Marquardt loop, in one kernel launch
per pyramid level (ops/fused_batch.fused_tr_level_batch).

Routing follows phovo_tpu:
  * sampling is always bilinear, whatever config.sampling says;
  * gradient_at is not read: the prep packs the 4-row geometry of the
    warped-point gradient whatever it says (phovo_tpu forces 'esm' to
    'warped' for the same prep, autodiff.py:220-223);
  * zero-init sequences run level-major, all pairs of a chunk in one
    launch per level; warm_start runs the pairs as a serial chain of
    align_autodiff calls (each pair starts where the last one ended);
  * keyframe tracking runs a chunk of frames against one keyframe
    level-major from explicit per-pair inits, one launch per level with
    the keyframe's 4-row packs shared by every pair
    (track_chunk_levelmajor_tr);
  * levels with max_iterations 0 leave the state and report zero
    diagnostics on both routes;
  * jacobian_mode='jacfwd' (the exact derivative of the bilinear
    interpolant: torch.func.jacfwd over ops/residuals.residual_vector, plain
    torch on any device, as phovo_tpu's is XLA) runs each pair alone,
    level by level through the exact trust-region loop
    (solvers/trust_region.py); its sequences run the pairs one after the
    other, warm or from zero, and its keyframe chunks never run
    level-major.
Robust losses huber, cauchy and tukey weight the pixels at robust_delta
inside the kernel (the costs, and rho, are then weighted sums, as in
phovo_tpu); robust_loss='tdist' raises ValueError, as in phovo_tpu.
"""

from __future__ import annotations

import dataclasses

import torch

from phovo_tpu_torch.models.analytic import prep_frame_analytic, prep_frame_targets
from phovo_tpu_torch.models.base import (
    DEFAULT_DEVICE,
    AlignmentResult,
    PhotoconsistencyOdometryBase,
    chunk_device_prep,
    device_unit_intensity,
    sequence_scan,
    stack_levels,
)
from phovo_tpu_torch.ops import pyramid as pyr
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.fused import fused_tr_level, pack_target
from phovo_tpu_torch.ops.fused_batch import fused_tr_level_batch
from phovo_tpu_torch.ops.residuals import residual_valid_count, residual_vector
from phovo_tpu_torch.solvers.trust_region import residual_to_linearizer, trust_region_level
from phovo_tpu_torch.utils import profiling
from phovo_tpu_torch.utils.config import PhovoConfig


def _check_supported(config: PhovoConfig, jacobian_mode: str) -> None:
    if config.robust_loss == "tdist":
        raise ValueError(
            "robust_loss='tdist' needs the Gauss-Newton solver (its "
            "adaptive scale changes the cost between trust-region "
            "iterations, breaking the accept/reject comparison); use the "
            "'analytic' backend, or huber/cauchy/tukey here"
        )
    if jacobian_mode not in ("linearizer", "jacfwd"):
        raise ValueError(
            f"jacobian_mode={jacobian_mode!r}; expected 'linearizer' or 'jacfwd'"
        )


def align_autodiff(
    source_intensity: torch.Tensor,  # (H, W) uint8 or float32 0..1
    source_depth: torch.Tensor,  # (H, W) metres
    target_intensity: torch.Tensor,  # (H, W)
    target_depth: torch.Tensor,  # unused, like the reference Ceres backend
    intr: Intrinsics,
    init_state: torch.Tensor,  # (6,)
    config: PhovoConfig,
    jacobian_mode: str = "linearizer",
) -> AlignmentResult:
    """Align one pair coarse to fine, on the device the tensors live on:
    one trust-region kernel launch per active level (B = 1), or with
    jacobian_mode='jacfwd' the exact trust-region loop over
    torch.func.jacfwd of the residual."""
    del target_depth
    _check_supported(config, jacobian_mode)
    L, blur = config.num_levels, config.blur_filter_sizes
    with profiling.span("phovo.prep"):
        si = device_unit_intensity(source_intensity).to(torch.float32)
        ti = device_unit_intensity(target_intensity).to(torch.float32)
        int0 = pyr.build_pyramid(si, L, blur, blur_type=config.blur_type)
        dep0 = pyr.build_pyramid(source_depth.to(torch.float32), L)
        int1 = pyr.build_pyramid(ti, L, blur, blur_type=config.blur_type)

    state = init_state.to(device=si.device, dtype=torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=si.device)
    diags = [(zero,) * 5] * L
    for level in range(L - 1, -1, -1):
        if config.max_iterations[level] <= 0:
            continue
        if jacobian_mode == "jacfwd":
            res = trust_region_level(
                _jacfwd_linearizer(int0[level], dep0[level], int1[level], intr.at_level(level), config),
                state, config.trust_region_options(level),
            )
            state = res.state
            diags[level] = (torch.tensor(float(res.iterations), device=si.device), res.gradient_norm, res.cost,
                            res.num_valid, zero)
            continue
        img, scale = int1[level], config.gradient_scales[level]
        with profiling.span("phovo.prep"):
            t_all = pack_target(img, pyr.scharr(img, "x", scale), pyr.scharr(img, "y", scale))
        state, its, cost, gnorm, _, nvalid, masked = fused_tr_level(
            int0[level], dep0[level], t_all, intr.at_level(level), state,
            config.min_depth, config.max_depth,
            config.trust_region_options(level), sampling="bilinear",
            robust_loss=config.robust_loss, robust_delta=config.robust_delta,
        )
        diags[level] = (its.to(torch.float32), gnorm, cost, nvalid, masked)
    return stack_levels(state, diags)


def _jacfwd_linearizer(i0, d0, i1, intr, config: PhovoConfig):
    """linearize(state) -> NormalEquations of one level from (r,
    torch.func.jacfwd(r)) of residual_vector, robust-weighted, with
    residual_valid_count's valid count (phovo_tpu/models/autodiff.py:91-107)."""

    def r_fn(s):
        return residual_vector(s, i0, d0, i1, intr, min_depth=config.min_depth, max_depth=config.max_depth)

    def nv_fn(s):
        return residual_valid_count(s, d0, i1, intr, min_depth=config.min_depth, max_depth=config.max_depth)

    return residual_to_linearizer(
        lambda s: (r_fn(s), torch.func.jacfwd(r_fn)(s)),
        robust_loss=config.robust_loss, robust_delta=config.robust_delta, num_valid_fn=nv_fn,
    )


def align_sequence_autodiff_levelmajor(
    intensities: torch.Tensor,  # (B+1, H, W) uint8 or float32
    depths: torch.Tensor,  # (B+1, H, W) metres
    intr: Intrinsics,
    config: PhovoConfig,
) -> AlignmentResult:
    """The zero-init sequence ordered level-major: each frame prepped once,
    then all B pairs' coarsest level in one kernel launch, then the next
    level, each pair with its own radius and termination."""
    intensities = device_unit_intensity(intensities).to(torch.float32)
    # the 4-row geometry of the warped-point gradient whatever gradient_at
    # says (an 'esm' config would pack six rows)
    prep_cfg = dataclasses.replace(config, gradient_at="warped")
    prep = prep_frame_analytic(intensities, depths.to(torch.float32), intr, prep_cfg)
    B = intensities.shape[0] - 1
    states = torch.zeros((B, 6), dtype=torch.float32, device=intensities.device)
    zero = torch.zeros(B, dtype=torch.float32, device=intensities.device)
    diags = [(zero,) * 5] * config.num_levels
    for level in range(config.num_levels - 1, -1, -1):
        if config.max_iterations[level] <= 0:
            continue
        H, W = pyr.level_shape(tuple(intensities.shape[1:]), level)
        i0, geom, t_all = prep[level]
        res = fused_tr_level_batch(
            i0[:-1], geom[:-1], t_all[1:], intr.at_level(level), states,
            config.trust_region_options(level), H=H, W=W, sampling="bilinear",
            robust_loss=config.robust_loss, robust_delta=config.robust_delta,
        )
        states = res.state
        diags[level] = (
            res.iterations.to(torch.float32), res.gradient_norm, res.cost,
            res.num_valid, res.band_masked,
        )
    return stack_levels(states, diags)


def tr_track_levelmajor_eligible(config: PhovoConfig, jacobian_mode: str = "linearizer") -> bool:
    """True when keyframe chunks of this backend run level-major: the
    linearizer Jacobian and any loss but 'tdist' (phovo_tpu/models/
    autodiff.py:269, without its TPU tiling gate)."""
    return jacobian_mode == "linearizer" and config.robust_loss != "tdist"


def track_chunk_levelmajor_tr(
    kf_prep: dict,  # prep_keyframe of a 'warped' config: level -> (i0 (1, N), geom (1, 4, N))
    intensities: torch.Tensor,  # (B, H, W) frames to track, uint8 or float32
    intr: Intrinsics,
    init_states: torch.Tensor,  # (B, 6) explicit per-pair inits
    config: PhovoConfig,
) -> AlignmentResult:
    """Track a chunk of B frames against ONE keyframe with the trust-region
    level, level-major (phovo_tpu/models/autodiff.py::
    track_chunk_levelmajor_tr): the frames are prepped as targets only,
    then per active level one launch of the trust-region kernel with the
    keyframe's packs shared by every pair, always bilinear. The keyframe
    packs have four rows whatever gradient_at says (models/keyframe.py
    preps them so)."""
    intensities = device_unit_intensity(intensities).to(torch.float32)
    shape = tuple(intensities.shape[1:])
    tgt = prep_frame_targets(intensities, config)
    B = intensities.shape[0]
    states = init_states.to(torch.float32).contiguous()
    zero = torch.zeros(B, dtype=torch.float32, device=intensities.device)
    diags = [(zero,) * 5] * config.num_levels
    for level in range(config.num_levels - 1, -1, -1):
        if config.max_iterations[level] <= 0:
            continue
        H, W = pyr.level_shape(shape, level)
        res = fused_tr_level_batch(
            *kf_prep[level], tgt[level], intr.at_level(level), states,
            config.trust_region_options(level), H=H, W=W, sampling="bilinear",
            robust_loss=config.robust_loss, robust_delta=config.robust_delta,
        )
        states = res.state
        diags[level] = (
            res.iterations.to(torch.float32), res.gradient_norm, res.cost,
            res.num_valid, res.band_masked,
        )
    return stack_levels(states, diags)


def align_sequence_autodiff(
    intensities: torch.Tensor,  # (B+1, H, W) consecutive frames
    depths: torch.Tensor,
    intr: Intrinsics,
    config: PhovoConfig,
    jacobian_mode: str = "linearizer",
    warm_start: bool = False,
) -> AlignmentResult:
    """Trust-region alignment of all consecutive pairs of a buffered
    segment (results have leading dim B): level-major from zero, or a
    serial chain of align_autodiff calls, warm-started or (jacfwd) each
    pair from zero."""
    _check_supported(config, jacobian_mode)
    if warm_start or jacobian_mode == "jacfwd":
        return sequence_scan(
            lambda si, sd, ti, td, init: align_autodiff(
                si, sd, ti, td, intr, init, config, jacobian_mode
            ),
            intensities, depths, warm_start=warm_start,
        )
    return align_sequence_autodiff_levelmajor(intensities, depths, intr, config)


def align_sequence_chunk_autodiff(
    carry_intensity: torch.Tensor,  # (H, W) last frame of the previous chunk
    carry_depth: torch.Tensor,  # (H, W)
    intensities: torch.Tensor,  # (B, H, W) new frames, uint8 or float32
    depths: torch.Tensor,  # (B, H, W) metres float32, or raw counts
    intr: Intrinsics,
    config: PhovoConfig,
    jacobian_mode: str = "linearizer",
    warm_start: bool = False,
    depth_scale: float | None = None,
) -> tuple[AlignmentResult, torch.Tensor, torch.Tensor]:
    """Streaming variant of align_sequence_autodiff (the carry frame stays
    on the device; see models/analytic.align_sequence_chunk). Returns
    (results over B pairs, new carry intensity, new carry depth)."""
    with profiling.span("phovo.align"):
        I, D = chunk_device_prep(
            carry_intensity, carry_depth, intensities, depths, depth_scale
        )
        res = align_sequence_autodiff(I, D, intr, config, jacobian_mode, warm_start)
        return res, I[-1], D[-1]


class PhotoconsistencyOdometryAutodiff(PhotoconsistencyOdometryBase):
    """Object API over align_autodiff (reference class
    CPhotoconsistencyOdometryCeres, ...Ceres.h:60)."""

    COST_IS_HALF_SUM_SQ = True  # cost = 0.5 * sum r^2 (Ceres)

    def __init__(
        self,
        config: PhovoConfig | None = None,
        jacobian_mode: str = "linearizer",
        device=DEFAULT_DEVICE,
    ):
        super().__init__(config, device)
        self.jacobian_mode = jacobian_mode

    def align(self, si, sd, ti, td, intr, init_state) -> AlignmentResult:
        return align_autodiff(
            si, sd, ti, td, intr, init_state, self.config, self.jacobian_mode
        )
