"""Per-iteration alignment trace: the reference's visualizeIterations
(torch port of phovo_tpu/utils/trace.py).

The reference shows |target - warped source| after every Gauss-Newton
iteration (CPhotoconsistencyOdometryAnalytic.h:551-557). The production
solvers run a level's iterations inside one kernel launch, so the
equivalent here is a diagnostic replay: a host-driven loop with the
solvers' per-level linearization and update rule that records the state
after every iteration, from which per-iteration difference images are
written as PNGs.

The replay linearizes once an iteration. With gradient_at 'warped' or
'esm' that is ops/fused.make_fused_linearizer (the one-linearization
kernel, K-LIN, on CUDA tensors; its plain version on CPU tensors), packs
built once a level; gradient_at 'source' and the bi-objective backend
take the exact torch path, as ops/fused.fused_normal_equations
dispatches. Each iteration reads its gradient norm, cost and valid count
to the host: this is a diagnostic, not a production path.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from phovo_tpu_torch.models.base import DEFAULT_DEVICE
from phovo_tpu_torch.ops import fused as fused_ops
from phovo_tpu_torch.ops import pyramid as pyr
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.prep import device_unit_intensity
from phovo_tpu_torch.ops.residuals import (
    biobjective_residual_jacobian,
    normal_equations,
    photometric_residual_jacobian,
)
from phovo_tpu_torch.ops.robust import TDIST_BURNIN, tdist_scale_update
from phovo_tpu_torch.solvers.gauss_newton import solve6
from phovo_tpu_torch.utils.config import PhovoConfig


class TraceRecord(NamedTuple):
    level: int
    iteration: int  # 1-based, within the level
    state: np.ndarray  # (6,) after this iteration's update
    gradient_norm: float  # ||J^T r|| of the linearization that produced it
    cost: float
    num_valid: float


def _level_linearizer(level, config, bi, int0, dep0, int1, dep1, grads, intr_l):
    """linearize(state, sigma) -> NormalEquations of one level; sigma is
    the carried Student-t scale, or None for robust_delta."""
    gx1, gy1, gx0, gy0, dgx1, dgy1 = (g[level] if g is not None else None for g in grads)
    if bi:
        gain = torch.mean(int1[level]) / torch.mean(dep1[level])

        def linearize(s, sigma=None):
            r, J, valid = biobjective_residual_jacobian(
                int0[level], dep0[level], int1[level], dep1[level], gx1, gy1, dgx1, dgy1, s, intr_l,
                min_depth=config.min_depth, max_depth=config.max_depth, sampling=config.sampling,
                gradient_at=config.gradient_at, depth_gain=gain,
            )
            return normal_equations(r, J, valid, config.robust_loss, config.robust_delta if sigma is None else sigma)

        return linearize
    if config.gradient_at == "source":

        def linearize(s, sigma=None):
            r, J, valid = photometric_residual_jacobian(
                int0[level], dep0[level], int1[level], gx1, gy1, s, intr_l,
                min_depth=config.min_depth, max_depth=config.max_depth, sampling=config.sampling,
                gradient_at="source",
            )
            return normal_equations(r, J, valid, config.robust_loss, config.robust_delta if sigma is None else sigma)

        return linearize
    fused = fused_ops.make_fused_linearizer(
        int0[level], dep0[level], fused_ops.pack_target(int1[level], gx1, gy1), intr_l,
        config.min_depth, config.max_depth, config.sampling, config.robust_loss, config.robust_delta,
        (gx0, gy0) if config.gradient_at == "esm" else None,
    )
    return lambda s, sigma=None: fused(s, robust_scale=sigma)


def trace_alignment(
    source_intensity,
    source_depth,
    target_intensity,
    target_depth,
    intr: Intrinsics,
    config: PhovoConfig,
    backend: str = "analytic",
    init_state=None,
    device=DEFAULT_DEVICE,
) -> list[TraceRecord]:
    """Replay a coarse-to-fine alignment on `device` (the CUDA card unless
    the caller names another), recording every Gauss-Newton iteration:
    update, then that linearization's gradient norm gates the next
    iteration; with robust_loss 'tdist' the Student-t scale is carried
    coarse to fine after TDIST_BURNIN scale-only steps at the first active
    level. Frames are host arrays or tensors (uint8 intensity is scaled by
    1/255 on the device).

    Supports the Gauss-Newton backends ('analytic', 'biobjective'); the
    trust-region backend keeps its own radius state and reports per-level
    diagnostics in its AlignmentResult instead."""
    if backend not in ("analytic", "biobjective"):
        raise ValueError(
            f"iteration trace supports 'analytic' and 'biobjective', not {backend!r} (the trust-region backend "
            "reports per-level diagnostics from AlignmentResult instead)"
        )

    def on(x):
        return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x, device=device)

    si = device_unit_intensity(on(source_intensity)).to(torch.float32)
    ti = device_unit_intensity(on(target_intensity)).to(torch.float32)
    sd, td = on(source_depth).to(torch.float32), on(target_depth).to(torch.float32)
    L, blur, scales = config.num_levels, config.blur_filter_sizes, config.gradient_scales
    int0 = pyr.build_pyramid(si, L, blur, blur_type=config.blur_type)
    dep0 = pyr.build_pyramid(sd, L)
    int1 = pyr.build_pyramid(ti, L, blur, blur_type=config.blur_type)
    gx1, gy1 = pyr.build_gradient_pyramid(int1, scales)
    gx0 = gy0 = dgx1 = dgy1 = dep1 = None
    if config.gradient_at == "esm":
        gx0, gy0 = pyr.build_gradient_pyramid(int0, scales)
    bi = backend == "biobjective"
    if bi:
        dep1 = pyr.build_pyramid(td, L)
        dgx1, dgy1 = pyr.build_gradient_pyramid([d * (1.0 / config.max_depth) for d in dep1], scales)

    state = (torch.zeros(6, dtype=torch.float32, device=device) if init_state is None
             else on(init_state).to(torch.float32))
    records: list[TraceRecord] = []
    tdist = config.robust_loss == "tdist"
    sigma = torch.tensor(config.robust_delta, dtype=torch.float32, device=device) if tdist else None
    first_active = True
    for level in range(L - 1, -1, -1):
        iters = config.max_iterations[level]
        if iters <= 0:
            continue
        linearize = _level_linearizer(level, config, bi, int0, dep0, int1, dep1, (gx1, gy1, gx0, gy0, dgx1, dgy1),
                                      intr.at_level(level))
        lam, min_g = config.lambda_steps[level], config.min_gradient_norms[level]
        if tdist and first_active:
            for _ in range(TDIST_BURNIN):
                ne = linearize(state, sigma)
                sigma = tdist_scale_update(ne.cost, ne.num_valid)
        first_active = False
        for it in range(1, iters + 1):
            ne = linearize(state, sigma)
            if tdist:
                sigma = tdist_scale_update(ne.cost, ne.num_valid)
            step = solve6(ne.JtJ, ne.Jtr)
            state = torch.where(torch.all(torch.isfinite(step)), state - lam * step, state)
            gnorm = float(torch.linalg.norm(ne.Jtr))
            records.append(TraceRecord(level, it, state.cpu().numpy(), gnorm, float(ne.cost), float(ne.num_valid)))
            if gnorm < min_g:
                break
    return records


def save_iteration_diffs(
    records: list[TraceRecord],
    source_intensity,
    source_depth,
    target_intensity,
    intr: Intrinsics,
    out_dir,
    device=DEFAULT_DEVICE,
) -> list[str]:
    """Write each traced state's full-resolution |target - warped source|
    as level{L}_iter{NNN}.png in out_dir (the reference shows it at the
    level's resolution; full resolution shows strictly more), the warps on
    `device` (the CUDA card unless the caller names another). u8-range
    frames are scaled to [0, 1] first, so the images are unit range.
    Returns the paths."""
    from phovo_tpu_torch.utils.viz import alignment_diff, save_image

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    src = np.asarray(source_intensity, np.float32)
    if src.max() > 1.5:  # u8-range input
        src = src / 255.0
    tgt = np.asarray(target_intensity, np.float32)
    if tgt.max() > 1.5:
        tgt = tgt / 255.0
    paths = []
    for rec in records:
        diff = alignment_diff(src, source_depth, tgt, rec.state, intr, device=device)
        p = out / f"level{rec.level}_iter{rec.iteration:03d}.png"
        save_image(p, diff, unit_range=True)
        paths.append(str(p))
    return paths
