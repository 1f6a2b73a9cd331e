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
  * every route but jacfwd takes its packs from the prep layer
    (ops/prep.py: one K-PREP launch on the card for a pair, a chunk or a
    sequence);
  * the object API's pairs that take K-PREP on the card (capturable)
    replay one CUDA graph of the pair's K-PREP launch, K-TR levels and
    glue (models/base.PairGraph), captured at the first such pair and
    again when the config, the intrinsics or the frames' shapes or dtypes
    change;
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

from phovo_tpu_torch.models.base import (
    DEFAULT_DEVICE,
    AlignmentResult,
    PhotoconsistencyOdometryBase,
    sequence_scan,
    stack_levels,
)
from phovo_tpu_torch.ops import pyramid as pyr
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.fused_batch import fused_tr_level_batch
from phovo_tpu_torch.ops.prep import (
    chunk_device_prep,
    device_unit_intensity,
    frames_take_kernel,
    prep_chunk,
    prep_frames,
    prep_pair,
    prep_targets,
)
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
    the pair's packs of every active level at once (ops/prep.prep_pair,
    one K-PREP launch on the card), then one trust-region kernel launch
    per active level (B = 1); or with jacobian_mode='jacfwd' the exact
    trust-region loop over torch.func.jacfwd of the residual."""
    del target_depth
    _check_supported(config, jacobian_mode)
    if jacobian_mode == "jacfwd":
        return _align_jacfwd(source_intensity, source_depth, target_intensity, intr, init_state, config)
    packs = prep_pair(source_intensity, source_depth, target_intensity, intr, _prep_config(config))
    state = init_state.to(device=source_intensity.device, dtype=torch.float32).reshape(1, 6)
    res = _tr_pairs_levelmajor(packs, tuple(source_intensity.shape[-2:]), intr, config, state)
    return AlignmentResult(*(x[0] for x in res))


def _align_jacfwd(source_intensity, source_depth, target_intensity, intr, init_state, config) -> AlignmentResult:
    """align_autodiff's jacfwd mode: each active level through the exact
    trust-region loop over torch.func.jacfwd of the residual."""
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
        res = trust_region_level(
            _jacfwd_linearizer(int0[level], dep0[level], int1[level], intr.at_level(level), config),
            state, config.trust_region_options(level),
        )
        state = res.state
        diags[level] = (torch.tensor(float(res.iterations), device=si.device), res.gradient_norm, res.cost,
                        res.num_valid, zero)
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


def _prep_config(config: PhovoConfig) -> PhovoConfig:
    """The config the packs are prepped with: the 4-row geometry of the
    warped-point gradient whatever gradient_at says (an 'esm' config would
    pack six rows)."""
    return dataclasses.replace(config, gradient_at="warped")


def _tr_pairs_levelmajor(packs: dict, shape, intr: Intrinsics, config: PhovoConfig,
                         states: torch.Tensor) -> AlignmentResult:
    """B independent pairs level-major from their packs (level -> (i0 (B,
    N), geom (B, 4, N), t_all (B, 3, H, W)), or a shared source (1, ...))
    and states (B, 6): per active level, coarsest first, ONE trust-region
    launch for all B pairs, each pair with its own radius and
    termination."""
    states = states.to(torch.float32).contiguous()
    zero = torch.zeros(states.shape[0], dtype=torch.float32, device=states.device)
    diags = [(zero,) * 5] * config.num_levels
    for level in range(config.num_levels - 1, -1, -1):
        if config.max_iterations[level] <= 0:
            continue
        H, W = pyr.level_shape(shape, level)
        res = fused_tr_level_batch(
            *packs[level], intr.at_level(level), states,
            config.trust_region_options(level), H=H, W=W, sampling="bilinear",
            robust_loss=config.robust_loss, robust_delta=config.robust_delta,
        )
        states = res.state
        diags[level] = (
            res.iterations.to(torch.float32), res.gradient_norm, res.cost,
            res.num_valid, res.band_masked,
        )
    return stack_levels(states, diags)


def align_sequence_autodiff_levelmajor(
    intensities: torch.Tensor,  # (B+1, H, W) uint8 or float32
    depths: torch.Tensor,  # (B+1, H, W) metres
    intr: Intrinsics,
    config: PhovoConfig,
) -> AlignmentResult:
    """The zero-init sequence ordered level-major: each frame prepped once,
    then all B pairs' coarsest level in one kernel launch, then the next
    level, each pair with its own radius and termination."""
    prep = prep_frames(intensities, depths, intr, _prep_config(config))
    packs = {level: (i0[:-1], geom[:-1], t_all[1:]) for level, (i0, geom, t_all) in prep.items()}
    states = torch.zeros((intensities.shape[0] - 1, 6), dtype=torch.float32, device=intensities.device)
    return _tr_pairs_levelmajor(packs, tuple(intensities.shape[1:]), intr, config, states)


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
    tgt = prep_targets(intensities, config)
    packs = {level: (*kf_prep[level], t_all) for level, t_all in tgt.items()}
    return _tr_pairs_levelmajor(packs, tuple(intensities.shape[1:]), intr, config, init_states)


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
        if not warm_start and jacobian_mode == "linearizer":
            _check_supported(config, jacobian_mode)
            packs, ci, cd = prep_chunk(carry_intensity, carry_depth, intensities, depths, depth_scale, intr,
                                       _prep_config(config))
            states = torch.zeros((intensities.shape[0], 6), dtype=torch.float32, device=ci.device)
            return _tr_pairs_levelmajor(packs, tuple(intensities.shape[1:]), intr, config, states), ci, cd
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

    def capturable(self, device, shape, source_dtype, depth_dtype, target_dtype) -> bool:
        """True where align_autodiff is one K-PREP launch (prep_pair) and
        the K-TR levels with their glue, which synchronise nothing: the
        linearizer Jacobian, a loss other than tdist, and frames K-PREP
        takes on a CUDA card. The jacfwd mode, the CPU and the presets
        that blur an active level run eagerly."""
        return (self.jacobian_mode == "linearizer" and self.config.robust_loss != "tdist"
                and frames_take_kernel(self.config, shape, device, (source_dtype, target_dtype), (depth_dtype,)))
