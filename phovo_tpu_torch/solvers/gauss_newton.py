"""Lambda-damped Gauss-Newton with the reference termination criteria
(torch port of phovo_tpu/solvers/gauss_newton.py): the exact per-pair
oracle the level kernel is tested against.

Per level: g = J^T r; x <- x - lambda (J^T J)^{-1} g; stop once the
iteration count reaches max_iterations or ||g|| < min_gradient_norm (the
norm of the linearization that made the last update gates the next).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from phovo_tpu_torch.ops.residuals import NormalEquations


class GNLevelResult(NamedTuple):
    state: torch.Tensor  # (6,) final state for this level
    iterations: int  # number of GN updates performed
    gradient_norm: torch.Tensor  # ||J^T r|| at the last performed update
    cost: torch.Tensor  # sum of squared residuals at the last linearization
    num_valid: torch.Tensor  # valid-pixel count at the last linearization


def solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unrolled 6x6 Cholesky solve of A x = b (A symmetric positive
    definite); non-positive pivots are floored at 1e-30."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        s = A[i, i]
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        L[i][i] = torch.sqrt(torch.clamp(s, min=1e-30))
        inv_d = 1.0 / L[i][i]
        for j in range(i + 1, 6):
            s = A[j, i]
            for k in range(i):
                s = s - L[j][k] * L[i][k]
            L[j][i] = s * inv_d
    ys = [None] * 6
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * ys[k]
        ys[i] = s / L[i][i]
    xs = [None] * 6
    for i in range(5, -1, -1):
        s = ys[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * xs[k]
        xs[i] = s / L[i][i]
    return torch.stack(xs)


def gauss_newton_level(
    linearize: Callable[..., NormalEquations],
    init_state: torch.Tensor,
    max_iterations: int,
    min_gradient_norm: float,
    lambda_step: float = 1.0,
    adaptive_scale=None,
    adaptive_burnin: int = 0,
) -> GNLevelResult:
    """Run Gauss-Newton at one pyramid level. linearize(state) returns the
    level's NormalEquations; a non-finite step leaves the state where it
    is. max_iterations == 0 leaves the state untouched (skipped level).

    adaptive_scale (robust_loss='tdist'): the initial residual scale sigma;
    linearize is then called as linearize(state, sigma), and sigma is
    re-estimated after every linearization from its weighted cost and valid
    count (ops/robust.tdist_scale_update). adaptive_burnin runs that update
    that many times at the initial state before iterating. The final sigma
    is tdist_scale_update(result.cost, result.num_valid)."""
    state = init_state.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=state.device)
    it, gnorm, cost, nvalid = 0, float("inf"), zero, zero
    gnorm_t = zero
    if max_iterations <= 0:
        return GNLevelResult(state, it, gnorm_t, cost, nvalid)
    tdist = adaptive_scale is not None
    if tdist:
        from phovo_tpu_torch.ops.robust import tdist_scale_update

        sigma = torch.as_tensor(adaptive_scale, dtype=torch.float32, device=state.device)
        for _ in range(adaptive_burnin):
            ne = linearize(state, sigma)
            sigma = tdist_scale_update(ne.cost, ne.num_valid)
    while it < max_iterations and gnorm >= min_gradient_norm:
        if tdist:
            ne = linearize(state, sigma)
            sigma = tdist_scale_update(ne.cost, ne.num_valid)
        else:
            ne = linearize(state)
        step = solve6(ne.JtJ, ne.Jtr)
        if bool(torch.all(torch.isfinite(step))):
            state = state - lambda_step * step
        gnorm_t = torch.linalg.vector_norm(ne.Jtr)
        gnorm = float(gnorm_t)
        cost, nvalid = ne.cost, ne.num_valid
        it += 1
    return GNLevelResult(state, it, gnorm_t, cost, nvalid)
