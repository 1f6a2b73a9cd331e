"""Robust losses as IRLS row weights (torch port of phovo_tpu/ops/robust.py).

Minimizing sum w(r) r^2 is one IRLS step toward minimizing sum rho(r):
huber w = min(1, d/|r|); cauchy w = 1/(1 + (r/d)^2); tukey
w = (1 - (r/d)^2)^2 inside d, 0 beyond; tdist (Student-t, adaptive scale)
w = (nu + 1)/(nu + (r/sigma)^2) with delta the current scale sigma.
The weights serve the exact per-pair path and are the plain versions of
the kernels' per-pixel weights (csrc/phovo_linearize.cuh sqrt_weight),
in the same order of operations.
"""

from __future__ import annotations

import torch

LOSSES = ("none", "huber", "cauchy", "tukey", "tdist")

# Student-t degrees of freedom for robust_loss='tdist' (Kerl et al. 2013)
TDIST_DOF = 5.0

# Floor of the adaptive Student-t scale: a perfectly aligned pair would
# otherwise collapse sigma to 0 and divide by it next iteration.
TDIST_MIN_SCALE = 1e-4

# Scale-only fixed-point passes at the initial state of the FIRST active
# pyramid level, where sigma starts from the config seed; later levels
# inherit the previous level's sigma.
TDIST_BURNIN = 4


def robust_weight(residual: torch.Tensor, loss: str, delta) -> torch.Tensor:
    """IRLS weight per residual element; loss='none' returns ones."""
    if loss == "none":
        return torch.ones_like(residual)
    if loss == "tdist":
        q = (residual / delta) ** 2
        return (TDIST_DOF + 1.0) / (TDIST_DOF + q)
    a = torch.abs(residual)
    if loss == "huber":
        return torch.clamp(delta / torch.clamp(a, min=1e-12), max=1.0)
    if loss == "cauchy":
        return 1.0 / (1.0 + (residual / delta) ** 2)
    if loss == "tukey":
        q = torch.clamp(1.0 - (residual / delta) ** 2, min=0.0)
        return q * q
    raise ValueError(f"unknown robust loss {loss!r}; expected one of {LOSSES}")


def tdist_scale_update(weighted_cost: torch.Tensor, num_valid: torch.Tensor) -> torch.Tensor:
    """One fixed-point step of the Student-t scale estimator:
    sigma = max(sqrt(sum w r^2 / max(n, 1)), TDIST_MIN_SCALE), from a
    linearization's weighted cost and valid count, in float32 (the level
    kernels compute the same expression)."""
    var = weighted_cost / torch.clamp(num_valid, min=1.0)
    return torch.clamp(torch.sqrt(var), min=TDIST_MIN_SCALE)


def sqrt_weight(residual: torch.Tensor, loss: str, delta) -> torch.Tensor:
    """sqrt of the IRLS weight, applied to residual AND Jacobian rows so
    that the Gram of the scaled rows is the weighted normal system."""
    if loss == "none":
        return torch.ones_like(residual)
    return torch.sqrt(robust_weight(residual, loss, delta))
