"""Inverse-compositional Gauss-Newton backend (torch port of
phovo_tpu/models/ic.py): a fourth aligner beside the reference's three,
whose Jacobian and Cholesky factor come from the SOURCE frame once per
level (ops/ic.py has the algorithm).

Routing: the kernels' route (use_fused) is one loop, _ic_pairs_levelmajor,
one K-IC launch per active level for a batch of pairs, the poses carried
as 4x4 matrices between levels and one se3.matrix_to_state at the end. A
single pair is a batch of one:
  * per pair, align_ic preps the source (prep_frame_ic), takes the
    target's intensity pyramid and runs the loop at B = 1;
    use_fused=False runs the exact torch path (ops/ic.ic_precompute,
    ic_gn_level_exact), as phovo_tpu runs its XLA form;
  * frame chains from zero prep each frame once (pyramid, source Scharr,
    one K-ICpre launch per active level for all frames) and run the loop
    over all pairs; warm_start runs the serial chain of align_ic, and
    use_fused=False the exact path pair after pair.
phovo_tpu's TPU gating (VMEM tilings, its height cap, the level-major
switch) has no counterpart: the GPU kernels take every level size.

The gradient convention: IC chains with the SOURCE image gradient, so
gradient_scales should approximate the true derivative (Scharr is
unnormalized by 32; 1/32 makes J metric); the analytic preset's 0.0625
also converges, with uniformly halved steps. robust_loss other than 'none'
raises ValueError: the factor is precomputed from the source frame, and
IRLS weights would change J^T W J every iteration.
"""

from __future__ import annotations

import torch

from phovo_tpu_torch.models.analytic import _gn_options
from phovo_tpu_torch.models.base import (
    DEFAULT_DEVICE,
    AlignmentResult,
    PhotoconsistencyOdometryBase,
    sequence_scan,
    stack_levels,
)
from phovo_tpu_torch.ops import ic as ic_ops
from phovo_tpu_torch.ops import pyramid as pyr
from phovo_tpu_torch.ops import se3
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.fused import pack_geometry
from phovo_tpu_torch.ops.ic_batch import ic_gn_level_batch
from phovo_tpu_torch.ops.prep import chunk_device_prep, device_unit_intensity
from phovo_tpu_torch.utils.config import PhovoConfig


def _check_loss(config: PhovoConfig) -> None:
    if config.robust_loss != "none":
        raise ValueError(
            "the IC backend does not support robust_loss="
            f"{config.robust_loss!r} (its factorization is precomputed from "
            "the source frame); use backend 'analytic', 'biobjective' or "
            "'ceres', or set robust_loss: none"
        )


def _coarse_to_fine(run_level, T: torch.Tensor, config: PhovoConfig) -> AlignmentResult:
    """Run the active levels coarse to fine from pose T ((4, 4) for one
    pair, (B, 4, 4) for B pairs). run_level(level, T) -> (T, iterations,
    gradient_norm, cost, num_valid) of that level. Skipped levels leave the
    pose and report zeros; the state is extracted once, at the end."""
    zero = torch.zeros(T.shape[:-2], dtype=torch.float32, device=T.device)
    diags = [(zero,) * 5] * config.num_levels
    for level in range(config.num_levels - 1, -1, -1):
        if config.max_iterations[level] <= 0:
            continue
        T, its, gnorm, cost, nvalid = run_level(level, T)
        diags[level] = (its.to(torch.float32), gnorm, cost, nvalid, zero)
    return stack_levels(se3.matrix_to_state(T), diags)


def align_ic(
    source_intensity: torch.Tensor,  # (H, W) uint8 or float32 0..1
    source_depth: torch.Tensor,  # (H, W) metres
    target_intensity: torch.Tensor,  # (H, W)
    target_depth: torch.Tensor,  # unused (parity with the other backends)
    intr: Intrinsics,
    init_state: torch.Tensor,  # (6,)
    config: PhovoConfig,
    use_fused: bool = True,
) -> AlignmentResult:
    """Align one pair coarse to fine on the device the tensors live on:
    the source's products (prep_frame_ic, one K-ICpre launch per active
    level) and the target's level images, then _ic_pairs_levelmajor at
    B = 1, one K-IC launch per active level; or the exact torch path with
    use_fused=False."""
    del target_depth
    _check_loss(config)
    si = device_unit_intensity(source_intensity).to(torch.float32)
    ti = device_unit_intensity(target_intensity).to(torch.float32)
    sd = source_depth.to(device=si.device, dtype=torch.float32)
    L, blur = config.num_levels, config.blur_filter_sizes
    int1 = pyr.build_pyramid(ti, L, blur, blur_type=config.blur_type)
    T = se3.pose_matrix(init_state.to(device=si.device, dtype=torch.float32))
    if use_fused:
        pairs = {level: (geom, J8, Lrow, int1[level][None].contiguous())
                 for level, (geom, J8, Lrow, _) in prep_frame_ic(si[None], sd[None], intr, config).items()}
        res = _ic_pairs_levelmajor(pairs, tuple(si.shape), intr, config, T[None])
        return AlignmentResult(*(x[0] for x in res))
    int0 = pyr.build_pyramid(si, L, blur, blur_type=config.blur_type)
    dep0 = pyr.build_pyramid(sd, L)
    # the SOURCE gradients (the defining difference from the forward backends)
    gx0, gy0 = pyr.build_gradient_pyramid(int0, config.gradient_scales)
    limits = (config.min_depth, config.max_depth)

    def run_level(level, T):
        intr_l = intr.at_level(level)
        J8, chol = ic_ops.ic_precompute(int0[level], dep0[level], gx0[level], gy0[level], intr_l, *limits)
        return ic_ops.ic_gn_level_exact(
            T, dep0[level], J8, chol, int1[level], intr_l,
            *_gn_options(config, level), config.sampling,
        )[:5]

    return _coarse_to_fine(run_level, T, config)


def prep_frame_ic(
    intensity: torch.Tensor,  # (F, H, W) float32 0..1
    depth: torch.Tensor,  # (F, H, W) metres
    intr: Intrinsics,
    config: PhovoConfig,
) -> dict:
    """Per-frame products of every ACTIVE level, for F frames at once:
    level -> (geom (F, 4, H*W) pack_geometry rows, J8 (F, 8, H*W), L
    (F, 36), target intensity (F, H, W)). A frame is one pair's target
    (its intensity) and the next pair's source (its Jacobian system), so
    each is computed once; one K-ICpre launch per level serves every
    frame."""
    L = config.num_levels
    int_p = pyr.build_pyramid(intensity, L, config.blur_filter_sizes, blur_type=config.blur_type)
    dep_p = pyr.build_pyramid(depth, L)
    limits = (config.min_depth, config.max_depth)
    out = {}
    for level in range(L):
        if config.max_iterations[level] <= 0:
            continue
        img = int_p[level].contiguous()
        dep = dep_p[level].contiguous()
        scale = config.gradient_scales[level]
        intr_l = intr.at_level(level)
        J8, Lrow = ic_ops.ic_precompute_batch(
            img, dep, pyr.scharr(img, "x", scale), pyr.scharr(img, "y", scale), intr_l, *limits,
        )
        out[level] = (pack_geometry(dep, intr_l, *limits), J8, Lrow, img)
    return out


def align_sequence_ic_levelmajor(
    intensities: torch.Tensor,  # (B+1, H, W) float32 0..1 or uint8
    depths: torch.Tensor,  # (B+1, H, W) metres
    intr: Intrinsics,
    config: PhovoConfig,
) -> AlignmentResult:
    """align_sequence_ic from zero, ordered level-major: every frame
    prepped once (prep_frame_ic), then _ic_pairs_levelmajor over all B
    pairs. Pair k aligns frame k (source) to frame k+1 (target)."""
    intensities = device_unit_intensity(intensities).to(torch.float32)
    prep = prep_frame_ic(intensities, depths.to(torch.float32), intr, config)
    pairs = {level: (geom[:-1], J8[:-1], Lrow[:-1], img[1:]) for level, (geom, J8, Lrow, img) in prep.items()}
    Ts = torch.eye(4, dtype=torch.float32, device=intensities.device).repeat(intensities.shape[0] - 1, 1, 1)
    return _ic_pairs_levelmajor(pairs, tuple(intensities.shape[1:]), intr, config, Ts)


def _ic_pairs_levelmajor(pairs: dict, shape, intr: Intrinsics, config: PhovoConfig, Ts) -> AlignmentResult:
    """The IC kernels' one loop: B pairs from poses Ts (B, 4, 4) and packs
    level -> (geom (B, 4, H*W), J8 (B, 8, H*W), L (B, 36) of the sources,
    target intensity (B, H, W)), one K-IC launch per active level. Returns
    batched results: state (B, 6), per-level diagnostics (B, L)."""

    def run_level(level, Ts):
        H, W = pyr.level_shape(shape, level)
        return ic_gn_level_batch(
            Ts, *pairs[level], intr.at_level(level), *_gn_options(config, level), H=H, W=W,
            sampling=config.sampling, mix_mode=config.mix_mode,
        )[:5]

    return _coarse_to_fine(run_level, Ts, config)


def align_sequence_ic(
    intensities: torch.Tensor,  # (B+1, H, W) consecutive frames
    depths: torch.Tensor,  # (B+1, H, W)
    intr: Intrinsics,
    config: PhovoConfig,
    use_fused: bool = True,
    warm_start: bool = False,
) -> AlignmentResult:
    """Align all consecutive pairs of a buffered frame sequence: results
    have leading dim B (pair k aligns frame k -> k+1), on the device the
    tensors live on. From zero with the kernels: level-major. warm_start:
    the serial chain of align_ic, each pair from the state the last one
    ended at. use_fused=False: the exact path, pair after pair."""
    _check_loss(config)
    if use_fused and not warm_start:
        return align_sequence_ic_levelmajor(intensities, depths, intr, config)
    return sequence_scan(
        lambda si, sd, ti, td, init: align_ic(si, sd, ti, td, intr, init, config, use_fused),
        intensities, depths, warm_start,
    )


def align_sequence_chunk_ic(
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
    """Streaming variant of align_sequence_ic for the chunked VO pipeline
    (models/analytic.align_sequence_chunk's contract): the carry frame
    stays on the device, the chunk arrives in storage dtype. Returns
    (results over B pairs, new carry intensity, new carry depth)."""
    I, D = chunk_device_prep(carry_intensity, carry_depth, intensities, depths, depth_scale)
    return align_sequence_ic(I, D, intr, config, use_fused, warm_start), I[-1], D[-1]


class PhotoconsistencyOdometryIC(PhotoconsistencyOdometryBase):
    """Object API over align_ic (no reference counterpart; phovo_tpu's
    fourth backend)."""

    def __init__(self, config: PhovoConfig | None = None, use_fused: bool = True, device=DEFAULT_DEVICE):
        super().__init__(config, device)
        self.use_fused = use_fused

    def align(self, si, sd, ti, td, intr, init_state) -> AlignmentResult:
        return align_ic(si, sd, ti, td, intr, init_state, self.config, self.use_fused)

    def align_full_band(self, si, sd, ti, td, intr, init_state) -> AlignmentResult:
        """The exact torch path (phovo_tpu's band fallback re-runs a pair
        there; the GPU kernel has no band, so nothing calls it here)."""
        return align_ic(si, sd, ti, td, intr, init_state, self.config, use_fused=False)
