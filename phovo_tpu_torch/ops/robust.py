"""Robust losses as IRLS row weights (torch port of phovo_tpu/ops/robust.py).

Minimizing sum w(r) r^2 is one IRLS step toward minimizing sum rho(r):
huber w = min(1, d/|r|); cauchy w = 1/(1 + (r/d)^2); tukey
w = (1 - (r/d)^2)^2 inside d, 0 beyond; tdist (Student-t, adaptive scale)
w = (nu + 1)/(nu + (r/sigma)^2) with delta the current scale sigma.
The level-major path runs robust_loss='none' only; the weights serve the
exact per-pair path.
"""

from __future__ import annotations

import torch

LOSSES = ("none", "huber", "cauchy", "tukey", "tdist")

# Student-t degrees of freedom for robust_loss='tdist' (Kerl et al. 2013)
TDIST_DOF = 5.0


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


def sqrt_weight(residual: torch.Tensor, loss: str, delta) -> torch.Tensor:
    """sqrt of the IRLS weight, applied to residual AND Jacobian rows so
    that the Gram of the scaled rows is the weighted normal system."""
    if loss == "none":
        return torch.ones_like(residual)
    return torch.sqrt(robust_weight(residual, loss, delta))
