"""Bi-objective (intensity + depth) Gauss-Newton backend (torch port of
phovo_tpu/models/biobjective.py).

Joint photometric and depth residuals with separated rigid and projection
Jacobians (the reference's CPhotoconsistencyOdometryBiObjective). Per
level the depth channel is weighted by gain = mean(I1) / mean(D1) of the
TARGET level. Intensity pyramids are blurred as configured, depth
pyramids are not, and the depth gradients are Scharr of depth * (1 /
max_depth). The deliberate divergences from the reference are
phovo_tpu's: the two channels' residuals are disjoint, and the depth
residual pairs D1(warped) with the transformed source depth.

Routing follows models/analytic.py, without phovo_tpu's TPU-only limits
(no height cap, no VMEM tiling gate, no band). The level kernel's route
(gradient_at 'warped', use_fused) is analytic's one loop,
align_pairs_levelmajor, on the frames' products (prep_frame_biobjective:
pyramids, Scharr, six-channel stacks, gains, each frame prepped once):
one K-GN-bi launch per active level for a batch of pairs, each pair's
gain from its target frame. A single pair and a warm chain's pair are
batches of one:
  * per pair, align_biobjective preps the pair's two frames and runs the
    loop at B = 1;
  * gradient_at='source' and use_fused=False run the exact torch path,
    gauss_newton_level over biobjective_residual_jacobian +
    normal_equations, as phovo_tpu runs them through XLA;
  * frame chains from zero run the loop over all pairs; warm_start runs
    the serial chain of analytic.align_prepped, the loop at B = 1 a pair,
    over per-frame products computed once.
gradient_at='esm' and robust_loss='tdist' raise ValueError on every entry
point, as in phovo_tpu.
"""

from __future__ import annotations

import torch

from phovo_tpu_torch.models.analytic import (
    _align_one,
    _chain_pairs,
    _coarse_to_fine,
    _gn_options,
    align_pairs_levelmajor,
    align_prepped,
)
from phovo_tpu_torch.models.base import (
    DEFAULT_DEVICE,
    AlignmentResult,
    PhotoconsistencyOdometryBase,
    prepped_chain,
    sequence_scan,
)
from phovo_tpu_torch.ops import pyramid as pyr
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.fused import pack_geometry, pack_target
from phovo_tpu_torch.ops.prep import chunk_device_prep, device_unit_intensity
from phovo_tpu_torch.ops.residuals import biobjective_residual_jacobian, normal_equations
from phovo_tpu_torch.solvers.gauss_newton import gauss_newton_level
from phovo_tpu_torch.utils.config import PhovoConfig


def _check_config(config: PhovoConfig) -> None:
    if config.gradient_at == "esm":
        raise ValueError(
            "gradient_at='esm' is photometric-only; the bi-objective "
            "backend supports 'warped' and 'source'"
        )
    if config.robust_loss == "tdist":
        raise ValueError(
            "robust_loss='tdist' is photometric-only (the intensity and "
            "depth channels would need separate adaptive scales); use "
            "huber/cauchy/tukey for the bi-objective backend"
        )


def _fused_route(config: PhovoConfig, use_fused: bool) -> bool:
    """True when the level kernel runs: every level size on the GPU."""
    return use_fused and config.gradient_at == "warped"


def _depth_cols(depth: torch.Tensor, config: PhovoConfig, level: int):
    """(depth, d/dx, d/dy) of one depth level: Scharr of depth * (1 /
    max_depth) at the level's gradient scale (phovo_tpu/models/
    biobjective.py:78-81)."""
    norm = depth * (1.0 / config.max_depth)
    scale = config.gradient_scales[level]
    return depth, pyr.scharr(norm, "x", scale), pyr.scharr(norm, "y", scale)


def _gain(intensity: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """mean(I1) / mean(D1) of (..., H, W) target levels, one per frame."""
    return intensity.mean(dim=(-2, -1)) / depth.mean(dim=(-2, -1))


def align_biobjective(
    source_intensity: torch.Tensor,  # (H, W) uint8 or float32 0..1
    source_depth: torch.Tensor,  # (H, W) metres
    target_intensity: torch.Tensor,  # (H, W)
    target_depth: torch.Tensor,  # (H, W) metres
    intr: Intrinsics,
    init_state: torch.Tensor,  # (6,)
    config: PhovoConfig,
    use_fused: bool = True,
) -> AlignmentResult:
    """Align one pair coarse to fine on the device the tensors live on: the
    two frames' products (prep_frame_biobjective), then
    align_pairs_levelmajor at B = 1, one K-GN-bi launch per active level;
    or the exact torch path for gradient_at='source' and use_fused=False."""
    _check_config(config)
    if _fused_route(config, use_fused):
        I = torch.stack([device_unit_intensity(x).to(torch.float32) for x in (source_intensity, target_intensity)])
        D = torch.stack([x.to(device=I.device, dtype=torch.float32) for x in (source_depth, target_depth)])
        prep, shape, _ = _prep_chain(I, D, intr, config)
        return _align_one(_chain_pairs(prep), shape, intr, config, init_state)
    si = device_unit_intensity(source_intensity).to(torch.float32)
    ti = device_unit_intensity(target_intensity).to(torch.float32)
    L, blur, scales = config.num_levels, config.blur_filter_sizes, config.gradient_scales
    int0 = pyr.build_pyramid(si, L, blur, blur_type=config.blur_type)
    dep0 = pyr.build_pyramid(source_depth.to(device=si.device, dtype=torch.float32), L)
    int1 = pyr.build_pyramid(ti, L, blur, blur_type=config.blur_type)
    dep1 = pyr.build_pyramid(target_depth.to(device=si.device, dtype=torch.float32), L)
    gx1, gy1 = pyr.build_gradient_pyramid(int1, scales)

    def run_level(level, state, sigma, burnin):
        del sigma, burnin  # no Student-t scale: tdist is refused
        intr_l = intr.at_level(level)
        dep, dgx, dgy = _depth_cols(dep1[level], config, level)
        gain = _gain(int1[level], dep)

        def linearize(s):
            r, J, valid = biobjective_residual_jacobian(
                int0[level], dep0[level], int1[level], dep, gx1[level],
                gy1[level], dgx, dgy, s, intr_l,
                min_depth=config.min_depth, max_depth=config.max_depth,
                sampling=config.sampling, gradient_at=config.gradient_at,
                depth_gain=gain,
            )
            return normal_equations(r, J, valid, config.robust_loss, config.robust_delta)

        res = gauss_newton_level(linearize, state, *_gn_options(config, level))
        its = torch.tensor(float(res.iterations), device=state.device)
        return res.state, its, res.gradient_norm, res.cost, res.num_valid

    state = init_state.to(device=si.device, dtype=torch.float32)
    return _coarse_to_fine(run_level, state, config)


def prep_frame_biobjective(
    intensity: torch.Tensor,  # (..., H, W) float32 0..1
    depth: torch.Tensor,  # (..., H, W) float32 metres
    intr: Intrinsics,
    config: PhovoConfig,
) -> dict:
    """Per-frame products for every ACTIVE pyramid level: level -> (i0
    (..., H*W), geom (..., 4, H*W), t6 (..., 6, H, W) [I, gx, gy, D, dgx,
    dgy], gain (...,) mean(I) / mean(D)); leading dims are frames."""
    L = config.num_levels
    int_p = pyr.build_pyramid(intensity, L, config.blur_filter_sizes, blur_type=config.blur_type)
    dep_p = pyr.build_pyramid(depth, L)
    out = {}
    for level in range(L):
        if config.max_iterations[level] <= 0:
            continue
        img, dep = int_p[level], dep_p[level]
        scale = config.gradient_scales[level]
        out[level] = (
            img.reshape(*img.shape[:-2], -1),
            pack_geometry(dep, intr.at_level(level), config.min_depth, config.max_depth),
            pack_target(img, pyr.scharr(img, "x", scale), pyr.scharr(img, "y", scale),
                        _depth_cols(dep, config, level)),
            _gain(img, dep),
        )
    return out


def _prep_chain(intensities, depths, intr, config):
    """(per-frame products, frame shape, number of pairs) of a chain."""
    intensities = device_unit_intensity(intensities).to(torch.float32)
    prep = prep_frame_biobjective(intensities, depths.to(torch.float32), intr, config)
    return prep, tuple(intensities.shape[1:]), intensities.shape[0] - 1


def align_sequence_biobjective_prepped(
    intensities: torch.Tensor,  # (B+1, H, W) float32 0..1 or uint8
    depths: torch.Tensor,  # (B+1, H, W) float32 metres
    intr: Intrinsics,
    config: PhovoConfig,
) -> AlignmentResult:
    """The warm-started chain: the pairs in series over per-frame products
    computed once; pair k starts where pair k-1 ended (pair 0 from zero),
    each pair through align_pairs_levelmajor at B = 1 (align_prepped)."""
    prep, shape, B = _prep_chain(intensities, depths, intr, config)
    return prepped_chain(
        prep, B,
        lambda src, tgt, init: align_prepped(src, tgt, shape, intr, init, config),
        intensities.device,
    )


def align_sequence_biobjective_levelmajor(
    intensities: torch.Tensor,  # (B+1, H, W) float32 0..1 or uint8
    depths: torch.Tensor,  # (B+1, H, W) float32 metres
    intr: Intrinsics,
    config: PhovoConfig,
) -> AlignmentResult:
    """The zero-init chain ordered level-major: align_pairs_levelmajor, one
    K-GN-bi launch per active level for all B pairs (frame k source, frame
    k+1 target), each pair's depth gain from its target frame."""
    prep, shape, _ = _prep_chain(intensities, depths, intr, config)
    return align_pairs_levelmajor(_chain_pairs(prep), shape, intr, config)


def align_sequence_biobjective(
    intensities: torch.Tensor,  # (B+1, H, W) consecutive frames
    depths: torch.Tensor,  # (B+1, H, W) metres
    intr: Intrinsics,
    config: PhovoConfig,
    use_fused: bool = True,
    warm_start: bool = False,
) -> AlignmentResult:
    """Align all consecutive pairs of a buffered frame sequence (pair k
    aligns frame k -> k+1), on the device the tensors live on; unlike the
    photometric backends this one reads the target depth. Level-major from
    zero; a serial chain with warm_start; the exact torch path, pair after
    pair, where the kernel does not run (gradient_at='source',
    use_fused=False)."""
    _check_config(config)
    if not _fused_route(config, use_fused):
        return sequence_scan(
            lambda si, sd, ti, td, init: align_biobjective(si, sd, ti, td, intr, init, config, use_fused),
            intensities, depths, warm_start,
        )
    if warm_start:
        return align_sequence_biobjective_prepped(intensities, depths, intr, config)
    return align_sequence_biobjective_levelmajor(intensities, depths, intr, config)


def align_sequence_chunk_biobjective(
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
    """Streaming variant for phovo-vo --chunk --backend biobjective (the
    carry frame stays on the device; storage dtypes converted there; see
    analytic.align_sequence_chunk). Returns (results over B pairs, new
    carry intensity, new carry depth)."""
    I, D = chunk_device_prep(
        carry_intensity, carry_depth, intensities, depths, depth_scale
    )
    return align_sequence_biobjective(I, D, intr, config, use_fused, warm_start), I[-1], D[-1]


class PhotoconsistencyOdometryBiObjective(PhotoconsistencyOdometryBase):
    """Object API over align_biobjective (reference class
    CPhotoconsistencyOdometryBiObjective, ...BiObjective.h:57)."""

    def __init__(self, config: PhovoConfig | None = None, use_fused: bool = True, device=DEFAULT_DEVICE):
        super().__init__(config, device)
        self.use_fused = use_fused

    def align(self, si, sd, ti, td, intr, init_state) -> AlignmentResult:
        return align_biobjective(si, sd, ti, td, intr, init_state, self.config, self.use_fused)

    def align_full_band(self, si, sd, ti, td, intr, init_state) -> AlignmentResult:
        """The exact torch path (phovo_tpu's band fallback re-runs a pair
        there; the GPU kernel has no band, so nothing calls it here)."""
        return align_biobjective(si, sd, ti, td, intr, init_state, self.config, use_fused=False)
