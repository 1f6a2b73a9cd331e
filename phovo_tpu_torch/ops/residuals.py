"""Per-pixel photometric and bi-objective (intensity + depth) residuals and
analytic Jacobians (torch port of phovo_tpu/ops/residuals.py): the exact,
per-pair path that the level kernel is held against.

Residual i lives at SOURCE pixel i and compares the target sampled at the
warped coordinates with I0(i); the Jacobian is the exact separated chain
d(u, v)/d(point) @ d(point)/d(state), chained with the target gradient
sampled at the warped coordinates ('warped'), read at the source pixel
('source', the reference analytic kernel's convention) or averaged with
the source gradient ('esm').
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from phovo_tpu_torch.ops import se3
from phovo_tpu_torch.ops.camera import Intrinsics, backproject
from phovo_tpu_torch.ops.warp import sample_bilinear, sample_nearest, transform_points


class NormalEquations(NamedTuple):
    """Reduced Gauss-Newton quantities for one linearization."""

    JtJ: torch.Tensor  # (6, 6)
    Jtr: torch.Tensor  # (6,)
    cost: torch.Tensor  # sum of squared (weighted) residuals
    num_valid: torch.Tensor  # number of contributing pixels
    # pixels a banded sampling window dropped (phovo_tpu's TPU kernels);
    # always 0 here
    band_masked: torch.Tensor | float = 0.0


def rigid_jacobian(points: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """d(R p + t)/d(state): (..., 3) points -> (..., 3, 6); translation
    columns are the identity, rotation columns dR/d(angle) @ p."""
    dR = se3.rotation_jacobian_wrt_euler(state)  # (3[angle], 3, 3)
    rot_cols = torch.einsum("aij,...j->...ia", dR, points)
    eye = torch.eye(3, dtype=points.dtype, device=points.device)
    eye = eye.expand(*points.shape[:-1], 3, 3)
    return torch.cat([eye, rot_cols], dim=-1)


def projection_jacobian(tp: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """d(u, v)/d(transformed point): (..., 3) -> (..., 2, 3)."""
    tx, ty, tz = tp.unbind(-1)
    inv_z = 1.0 / tz
    zero = torch.zeros_like(tx)
    row_u = torch.stack([intr.fx * inv_z, zero, -intr.fx * tx * inv_z * inv_z], -1)
    row_v = torch.stack([zero, intr.fy * inv_z, -intr.fy * ty * inv_z * inv_z], -1)
    return torch.stack([row_u, row_v], dim=-2)


def warp_and_jacobian(
    source_depth: torch.Tensor,
    state: torch.Tensor,
    intr: Intrinsics,
    min_depth: float,
    max_depth: float,
    return_rigid: bool = False,
    row_offset: float = 0.0,
):
    """Shared geometry: (col, row, transformed points, J_pix (..., 2, 6),
    valid_src); return_rigid appends the rigid-transform Jacobian J_rt
    (..., 3, 6), whose z-row the bi-objective depth channel needs.
    row_offset: see ops/camera.py::backproject."""
    pts = backproject(source_depth, intr, row_offset)
    tp = transform_points(pts, se3.pose_matrix(state))
    tz = tp[..., 2]
    safe_z = torch.where(torch.abs(tz) > 1e-12, tz, torch.full_like(tz, 1e-12))
    tp_safe = torch.cat([tp[..., :2], safe_z[..., None]], dim=-1)
    col = tp_safe[..., 0] * intr.fx / safe_z + intr.cx
    row = tp_safe[..., 1] * intr.fy / safe_z + intr.cy
    J_rt = rigid_jacobian(pts, state)
    J_pix = projection_jacobian(tp_safe, intr) @ J_rt
    valid_src = (source_depth > min_depth) & (source_depth < max_depth) & (tz > 0)
    if return_rigid:
        return col, row, tp_safe, J_pix, valid_src, J_rt
    return col, row, tp_safe, J_pix, valid_src


def photometric_residual_jacobian(
    source_intensity: torch.Tensor,
    source_depth: torch.Tensor,
    target_intensity: torch.Tensor,
    target_grad_x: torch.Tensor,
    target_grad_y: torch.Tensor,
    state: torch.Tensor,
    intr: Intrinsics,
    min_depth: float = 0.3,
    max_depth: float = 5.0,
    sampling: str = "nearest",
    gradient_at: str = "warped",
    source_grad_x: torch.Tensor | None = None,
    source_grad_y: torch.Tensor | None = None,
    row_offset: float = 0.0,
):
    """Photometric residual field and analytic Jacobian rows. gradient_at:
    'warped' samples the target gradient at the warped coordinates;
    'source' reads it at the source pixel index (the reference analytic
    kernel, CPhotoconsistencyOdometryAnalytic.h:346-347); 'esm' averages
    the warped target gradient with the source gradient source_grad_x/y
    (Scharr of the source intensity at the same scale). row_offset: the
    global row of the source's row 0 where the source is a block of rows
    (parallel/sharded_ne.py; the target stays whole). Returns
    (residual (H, W), J (H, W, 6), valid (H, W))."""
    col, row, _, J_pix, valid_src = warp_and_jacobian(
        source_depth, state, intr, min_depth, max_depth, row_offset=row_offset
    )
    sample = sample_bilinear if sampling == "bilinear" else sample_nearest
    tgt_val, inb = sample(target_intensity, col, row)
    if gradient_at == "warped":
        gx, _ = sample(target_grad_x, col, row)
        gy, _ = sample(target_grad_y, col, row)
    elif gradient_at == "esm":
        if source_grad_x is None or source_grad_y is None:
            raise ValueError("gradient_at='esm' needs source_grad_x/y")
        gx1, _ = sample(target_grad_x, col, row)
        gy1, _ = sample(target_grad_y, col, row)
        gx = 0.5 * (gx1 + source_grad_x)
        gy = 0.5 * (gy1 + source_grad_y)
    elif gradient_at == "source":
        gx, gy = target_grad_x, target_grad_y
    else:
        raise ValueError(
            f"gradient_at={gradient_at!r}; expected 'warped', 'source' or 'esm'"
        )
    valid = valid_src & inb
    residual = torch.where(valid, tgt_val - source_intensity, torch.zeros_like(tgt_val))
    grad = torch.stack([gx, gy], dim=-1)  # (..., 2)
    J = (grad.unsqueeze(-2) @ J_pix).squeeze(-2)
    J = torch.where(valid[..., None], J, torch.zeros_like(J))
    return residual, J, valid


def biobjective_residual_jacobian(
    source_intensity: torch.Tensor,
    source_depth: torch.Tensor,
    target_intensity: torch.Tensor,
    target_depth: torch.Tensor,
    target_grad_x: torch.Tensor,
    target_grad_y: torch.Tensor,
    target_depth_grad_x: torch.Tensor,
    target_depth_grad_y: torch.Tensor,
    state: torch.Tensor,
    intr: Intrinsics,
    min_depth: float = 0.3,
    max_depth: float = 5.0,
    sampling: str = "nearest",
    gradient_at: str = "warped",
    depth_gain: torch.Tensor | float | None = None,
):
    """Joint intensity and depth residuals (the reference's bi-objective
    backend, phovo_tpu/ops/residuals.py::biobjective_residual_jacobian).
    Channel 0 is the photometric residual and row; channel 1 the depth
    residual gain (D1(warped) - tz), tz the transformed source depth, and
    its row gain (grad D . J_pix - J_rt z-row). gradient_at 'warped'
    samples the target gradients at the warped point, 'source' reads them
    at the source pixel. depth_gain defaults to mean(I1) / mean(D1).
    Returns (residual (2, H, W), J (2, H, W, 6), valid (H, W))."""
    if depth_gain is None:
        depth_gain = torch.mean(target_intensity) / torch.mean(target_depth)
    col, row, tp, J_pix, valid_src, J_rt = warp_and_jacobian(
        source_depth, state, intr, min_depth, max_depth, return_rigid=True
    )
    sample = sample_bilinear if sampling == "bilinear" else sample_nearest
    tgt_i, inb = sample(target_intensity, col, row)
    tgt_d, _ = sample(target_depth, col, row)
    if gradient_at == "warped":
        gx, _ = sample(target_grad_x, col, row)
        gy, _ = sample(target_grad_y, col, row)
        dgx, _ = sample(target_depth_grad_x, col, row)
        dgy, _ = sample(target_depth_grad_y, col, row)
    elif gradient_at == "source":
        gx, gy = target_grad_x, target_grad_y
        dgx, dgy = target_depth_grad_x, target_depth_grad_y
    else:
        raise ValueError(
            f"gradient_at={gradient_at!r}; the bi-objective residual takes "
            "'warped' or 'source'"
        )
    valid = valid_src & inb
    zero = torch.zeros_like(tgt_i)
    r_int = torch.where(valid, tgt_i - source_intensity, zero)
    J_int = (torch.stack([gx, gy], dim=-1).unsqueeze(-2) @ J_pix).squeeze(-2)
    r_dep = torch.where(valid, depth_gain * (tgt_d - tp[..., 2]), zero)
    J_dep = depth_gain * (
        (torch.stack([dgx, dgy], dim=-1).unsqueeze(-2) @ J_pix).squeeze(-2) - J_rt[..., 2, :]
    )
    vmask = valid[..., None]
    J = torch.stack([
        torch.where(vmask, J_int, torch.zeros_like(J_int)),
        torch.where(vmask, J_dep, torch.zeros_like(J_dep)),
    ])
    return torch.stack([r_int, r_dep]), J, valid


def normal_equations(
    residual: torch.Tensor,
    J: torch.Tensor,
    valid: torch.Tensor,
    robust_loss: str = "none",
    robust_delta: float = 0.1,
) -> NormalEquations:
    """Reduce a residual field to Gauss-Newton normal equations; with a
    robust loss every row is scaled by sqrt(w(r)) (one IRLS step) and the
    cost is the reweighted sum w r^2. residual and J may carry leading
    channels (the bi-objective (2, H, W)); the valid count is sum(valid),
    each pixel once."""
    if robust_loss != "none":
        from phovo_tpu_torch.ops.robust import sqrt_weight

        sw = sqrt_weight(residual, robust_loss, robust_delta)
        residual = residual * sw
        J = J * sw[..., None]
    Jf = J.reshape(-1, 6)
    rf = residual.reshape(-1)
    return NormalEquations(
        Jf.T @ Jf, Jf.T @ rf, torch.sum(rf * rf),
        torch.sum(valid.to(torch.float32)),
    )


def _warped_target_and_valid(state, source_depth, target_intensity, intr, min_depth, max_depth):
    """The warp and validity predicate of the jacfwd residual path: the
    target bilinear-sampled at the warped point, and valid = depth in
    (min_depth, max_depth), tz > 0 and in bounds. Out of place throughout,
    so torch.func.jacfwd runs through it."""
    tp = transform_points(backproject(source_depth, intr), se3.pose_matrix(state))
    tz = tp[..., 2]
    safe_z = torch.where(torch.abs(tz) > 1e-12, tz, torch.full_like(tz, 1e-12))
    col = tp[..., 0] * intr.fx / safe_z + intr.cx
    row = tp[..., 1] * intr.fy / safe_z + intr.cy
    tgt, inb = sample_bilinear(target_intensity, col, row)
    valid = (source_depth > min_depth) & (source_depth < max_depth) & (tz > 0) & inb
    return tgt, valid


def residual_vector(
    state: torch.Tensor,
    source_intensity: torch.Tensor,
    source_depth: torch.Tensor,
    target_intensity: torch.Tensor,
    intr: Intrinsics,
    min_depth: float = 0.3,
    max_depth: float = 5.0,
) -> torch.Tensor:
    """The residual field (H*W,) as a differentiable function of the state
    (phovo_tpu/ops/residuals.py::residual_vector): bilinear target minus
    source where valid, 0 elsewhere. torch.func.jacfwd of it is the exact
    derivative of the bilinear interpolant, the counterpart of the
    reference Ceres functor's Jets through SampleWithDerivative."""
    tgt, valid = _warped_target_and_valid(state, source_depth, target_intensity, intr, min_depth, max_depth)
    return torch.where(valid, tgt - source_intensity, torch.zeros_like(tgt)).reshape(-1)


def residual_valid_count(
    state, source_depth, target_intensity, intr, min_depth: float = 0.3, max_depth: float = 5.0,
) -> torch.Tensor:
    """Pixels contributing to residual_vector at this state (the num_valid
    the jacfwd linearization reports)."""
    _, valid = _warped_target_and_valid(state, source_depth, target_intensity, intr, min_depth, max_depth)
    return torch.sum(valid.to(torch.float32))
