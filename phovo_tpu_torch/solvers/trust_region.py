"""Trust-region Levenberg-Marquardt with the Ceres parameter schema (torch
port of phovo_tpu/solvers/trust_region.py): the exact per-pair solver the
trust-region level kernel is held against.

The reference delegates its autodiff backend to Ceres's trust-region LM with
per-level options (CPhotoconsistencyOdometryCeres.h:464-477). The step is
classic Levenberg-Marquardt on the normal equations,
    (J^T J + (1/radius) diag(J^T J)) dx = -J^T r,
accepted when rho = actual / predicted decrease exceeds
min_relative_decrease; the radius grows as radius / max(1/3, 1 - (2 rho -
1)^3) on acceptance and halves on rejection (Ceres's rule).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from phovo_tpu_torch.ops.residuals import NormalEquations
from phovo_tpu_torch.solvers.gauss_newton import solve6


class TRLevelResult(NamedTuple):
    state: torch.Tensor  # (6,)
    iterations: int  # LM iterations performed (accepted or not)
    cost: torch.Tensor  # final accepted cost (0.5 * sum r^2)
    gradient_norm: torch.Tensor  # max-norm of J^T r at termination
    radius: torch.Tensor  # final trust-region radius
    num_valid: torch.Tensor  # valid pixels at the last accepted linearization
    # pixels dropped by the TPU kernels' banded sampling window; always 0
    # in the port, which samples the whole target
    band_masked: torch.Tensor | float = 0.0


class TROptions(NamedTuple):
    max_iterations: int = 50
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8
    initial_trust_region_radius: float = 1e4
    max_trust_region_radius: float = 1e16
    min_trust_region_radius: float = 1e-32
    min_relative_decrease: float = 1e-3


def residual_to_linearizer(
    residual_and_jacobian: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    robust_loss: str = "none",
    robust_delta: float = 0.1,
    num_valid_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> Callable[[torch.Tensor], NormalEquations]:
    """Adapt an (r (N,), J (N, 6))-producing function to the
    NormalEquations interface. With a robust loss the rows are IRLS
    reweighted by sqrt(w(r)). num_valid_fn(state) supplies the valid-pixel
    count; without it num_valid is 0."""

    def linearize(state) -> NormalEquations:
        r, J = residual_and_jacobian(state)
        if robust_loss != "none":
            from phovo_tpu_torch.ops.robust import sqrt_weight

            sw = sqrt_weight(r, robust_loss, robust_delta)
            r = r * sw
            J = J * sw[:, None]
        nv = (
            torch.zeros((), dtype=torch.float32, device=r.device)
            if num_valid_fn is None
            else torch.as_tensor(num_valid_fn(state), dtype=torch.float32)
        )
        return NormalEquations(J.T @ J, J.T @ r, torch.dot(r, r), nv)

    return linearize


def trust_region_level(
    linearize: Callable[[torch.Tensor], NormalEquations],
    init_state: torch.Tensor,
    opts: TROptions,
) -> TRLevelResult:
    """Run trust-region LM at one pyramid level. linearize(state) returns
    NormalEquations with cost = sum r^2; the LM bookkeeping uses 0.5x like
    Ceres. max_iterations <= 0 returns the state untouched with zero
    diagnostics and the initial radius (a skipped level)."""
    state = init_state.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=state.device)
    zero = torch.zeros((), **f32)
    if opts.max_iterations <= 0:
        return TRLevelResult(
            state, 0, zero, zero,
            torch.tensor(opts.initial_trust_region_radius, **f32), zero,
        )
    ftol, gtol, ptol, rmax, rmin, mrd = (
        torch.tensor(v, **f32) for v in (
            opts.function_tolerance, opts.gradient_tolerance,
            opts.parameter_tolerance, opts.max_trust_region_radius,
            opts.min_trust_region_radius, opts.min_relative_decrease,
        )
    )

    ne = linearize(state)
    JtJ, Jtr, nv = ne.JtJ, ne.Jtr, ne.num_valid
    cost = 0.5 * ne.cost
    radius = torch.tensor(opts.initial_trust_region_radius, **f32)
    it = 0
    done = bool(torch.max(torch.abs(Jtr)) <= gtol)
    while it < opts.max_iterations and not done:
        diag = torch.clamp(torch.diagonal(JtJ), 1e-12, 1e32)
        step = solve6(JtJ + torch.diag(diag) / radius, -Jtr)
        if not bool(torch.all(torch.isfinite(step))):
            step = torch.zeros_like(step)
        new_state = state + step
        ne = linearize(new_state)
        new_cost = 0.5 * ne.cost

        predicted = torch.maximum(
            -torch.dot(step, Jtr) - 0.5 * torch.dot(step, JtJ @ step),
            torch.tensor(1e-30, **f32),
        )
        rho = (cost - new_cost) / predicted
        accept = bool(rho > mrd)
        if accept:
            t = 2.0 * rho - 1.0
            grow = radius / torch.clamp(1.0 - t * (t * t), min=1.0 / 3.0)
            new_radius = torch.minimum(grow, rmax)
        else:
            new_radius = radius * 0.5

        f_done = accept and bool(torch.abs(cost - new_cost) <= ftol * cost)
        p_done = accept and bool(
            torch.linalg.vector_norm(step)
            <= ptol * (torch.linalg.vector_norm(state) + ptol)
        )
        if accept:
            state, cost = new_state, new_cost
            JtJ, Jtr, nv = ne.JtJ, ne.Jtr, ne.num_valid
        g_done = bool(torch.max(torch.abs(Jtr)) <= gtol)
        r_done = bool(new_radius < rmin)
        done = f_done or g_done or p_done or r_done
        radius = new_radius
        it += 1
    return TRLevelResult(state, it, cost, torch.max(torch.abs(Jtr)), radius, nv)
