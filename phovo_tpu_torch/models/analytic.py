"""Analytic Gauss-Newton frame chain, level-major (torch port of the
zero-init sequence path of phovo_tpu/models/analytic.py).

Under the reference's pair semantics every pair starts from the zero state
(PhotoconsistencyVisualOdometry.cpp:224), so the pairs of a chunk are
independent: all pairs' coarsest level runs in one call of the level
kernel (ops/fused_batch.py), then all pairs' next level, and so on. Each
frame is prepped once (pyramid, Scharr, packs) and serves as the target of
one pair and the source of the next.

Only that route is ported: warm starts (each pair then depends on the one
before), robust losses and other Jacobian forms raise NotImplementedError.
"""

from __future__ import annotations

import torch

from phovo_tpu_torch.models.base import (
    AlignmentResult,
    chunk_device_prep,
    device_unit_intensity,
)
from phovo_tpu_torch.ops import pyramid as pyr
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.fused import pack_geometry, pack_target
from phovo_tpu_torch.ops.fused_batch import fused_gn_level_batch
from phovo_tpu_torch.utils.config import PhovoConfig


def _check_supported(config: PhovoConfig, warm_start: bool) -> None:
    if warm_start:
        raise NotImplementedError(
            "warm_start runs the pairs as a serial chain; it is not ported "
            "yet (ROADMAP.md queue A, item 4)"
        )
    if config.robust_loss != "none":
        raise NotImplementedError(
            f"robust_loss={config.robust_loss!r} is not ported to the level "
            "kernel yet (ROADMAP.md queue A, item 4)"
        )
    if config.gradient_at != "warped":
        raise NotImplementedError(
            f"gradient_at={config.gradient_at!r} is not ported to the level "
            "kernel yet (ROADMAP.md queue A, item 4)"
        )


def prep_frame_analytic(
    intensity: torch.Tensor,  # (..., H, W) float32 0..1
    depth: torch.Tensor,  # (..., H, W) float32 metres
    intr: Intrinsics,
    config: PhovoConfig,
) -> dict:
    """Per-frame packs for every ACTIVE pyramid level: level -> (i0
    (..., H*W), geom (..., 4, H*W), t_all (..., 3, H, W)); leading dims are
    frames."""
    L = config.num_levels
    int_p = pyr.build_pyramid(
        intensity, L, config.blur_filter_sizes, blur_type=config.blur_type
    )
    dep_p = pyr.build_pyramid(depth, L)
    out = {}
    for level in range(L):
        if config.max_iterations[level] <= 0:
            continue
        img = int_p[level]
        scale = config.gradient_scales[level]
        out[level] = (
            img.reshape(*img.shape[:-2], -1),
            pack_geometry(
                dep_p[level], intr.at_level(level), config.min_depth,
                config.max_depth,
            ),
            pack_target(img, pyr.scharr(img, "x", scale), pyr.scharr(img, "y", scale)),
        )
    return out


def align_pairs_levelmajor(
    prep_pairs: dict,
    shape: tuple[int, int],
    intr: Intrinsics,
    config: PhovoConfig,
) -> AlignmentResult:
    """Level-major alignment of B independent pairs from per-pair packs
    (level -> (i0 (B, N), geom (B, 4, N), t_all (B, 3, H, W)) for every
    active level), all starting from the zero state. Returns batched
    results: state (B, 6), per-level diagnostics (B, L)."""
    L = config.num_levels
    i0_any = next(iter(prep_pairs.values()))[0]
    B, device = i0_any.shape[0], i0_any.device
    states = torch.zeros((B, 6), dtype=torch.float32, device=device)
    zero = torch.zeros(B, dtype=torch.float32, device=device)
    skipped = (zero.to(torch.int32), zero, zero, zero, zero)
    diags = [skipped] * L
    for level in range(L - 1, -1, -1):
        if config.max_iterations[level] <= 0:
            continue
        H, W = pyr.level_shape(shape, level)
        i0, geom, t_all = prep_pairs[level]
        res = fused_gn_level_batch(
            i0, geom, t_all, intr.at_level(level), states,
            config.max_iterations[level], config.min_gradient_norms[level],
            config.lambda_steps[level], H=H, W=W, sampling=config.sampling,
        )
        states = res.state
        diags[level] = res[1:]
    return AlignmentResult(
        states, *(torch.stack([d[k] for d in diags], dim=1) for k in range(5))
    )


def align_sequence_levelmajor(
    intensities: torch.Tensor,  # (B+1, H, W) float32 0..1 or uint8
    depths: torch.Tensor,  # (B+1, H, W) float32 metres
    intr: Intrinsics,
    config: PhovoConfig,
) -> AlignmentResult:
    """align_sequence ordered level-major: each frame prepped once, pair k
    aligns frame k (source) to frame k+1 (target)."""
    intensities = device_unit_intensity(intensities).to(torch.float32)
    prep = prep_frame_analytic(intensities, depths, intr, config)
    prep_pairs = {
        level: (i0[:-1], geom[:-1], t_all[1:])
        for level, (i0, geom, t_all) in prep.items()
    }
    return align_pairs_levelmajor(prep_pairs, tuple(intensities.shape[1:]), intr, config)


def align_sequence(
    intensities: torch.Tensor,  # (B+1, H, W) consecutive frames
    depths: torch.Tensor,  # (B+1, H, W)
    intr: Intrinsics,
    config: PhovoConfig,
    warm_start: bool = False,
) -> AlignmentResult:
    """Align all consecutive pairs of a buffered frame sequence: results
    have leading dim B (pair k aligns frame k -> k+1). Runs on the device
    the tensors live on: the CUDA level kernel for CUDA tensors, its plain
    torch version for CPU tensors."""
    _check_supported(config, warm_start)
    return align_sequence_levelmajor(intensities, depths, intr, config)


def align_sequence_chunk(
    carry_intensity: torch.Tensor,  # (H, W) last frame of the previous chunk
    carry_depth: torch.Tensor,  # (H, W)
    intensities: torch.Tensor,  # (B, H, W) new frames, uint8 or float32
    depths: torch.Tensor,  # (B, H, W) metres float32, or raw counts
    intr: Intrinsics,
    config: PhovoConfig,
    warm_start: bool = False,
    depth_scale: float | None = None,
) -> tuple[AlignmentResult, torch.Tensor, torch.Tensor]:
    """Streaming variant of align_sequence for the chunked VO pipeline:
    the carry frame stays on the device and the chunk is prepended there,
    so per chunk the host moves only the new frames in storage dtype.
    Returns (results over B pairs, new carry intensity, new carry depth),
    the carries already converted to float32."""
    I, D = chunk_device_prep(
        carry_intensity, carry_depth, intensities, depths, depth_scale
    )
    return align_sequence(I, D, intr, config, warm_start), I[-1], D[-1]
