"""The reference's level solver of the analytic backend: Gauss-Newton
with a fixed step, stopped by a gradient-norm threshold or the budget
(the reference implementation's PhotoconsistencyOdometryAnalytic).
Found by the configuration file's "backend" name (reference/vo.py)."""

from __future__ import annotations

import math

import torch

from benchmark.reference import vo

# the preset keys this solver reads, besides those every solver reads
KEYS = ("lambda_steps", "min_gradient_norms")
SAMPLING = ("nearest", "bilinear")


def solve_level(state, packs, intr_l, H, W, cfg, level):
    return gn_level(state, packs, intr_l, H, W, cfg["sampling"] == "bilinear", cfg["max_iterations"][level],
                    cfg["min_gradient_norms"][level], cfg["lambda_steps"][level])


def gn_level(state, packs, intr_l, H, W, bilinear, max_it, min_gnorm, lam):
    """Gauss-Newton on one level: each pair steps state -= lam * (JtJ)^-1
    Jtr while it has budget left and the last gradient norm ||Jtr|| is at
    least min_gnorm (the first step always runs); a non-finite solve
    leaves its state. Returns (state, iterations, num_valid)."""
    B = state.shape[0]
    it = torch.zeros(B, dtype=torch.int64, device=state.device)
    gnorm = torch.full((B,), math.inf, device=state.device)
    nvalid = torch.zeros(B, device=state.device)
    while True:
        act = (it < max_it) & (gnorm >= min_gnorm)
        if not bool(act.any()):
            break
        JtJ, Jtr, _, nv = vo.linearize(state, *packs, intr_l, H, W, bilinear)
        x = vo.chol_solve6(JtJ, Jtr)
        upd = act & torch.isfinite(x).all(1)
        state = torch.where(upd[:, None], state - lam * x, state)
        gnorm = torch.where(act, torch.sqrt(vo.dot6(Jtr, Jtr)), gnorm)
        nvalid = torch.where(act, nv, nvalid)
        it = it + act.long()
    return state, it, nvalid
