"""The reference's level solver of the ceres backend: Ceres's trust-region
Levenberg-Marquardt with the preset's tolerances and radii, bilinear
sampling (the reference implementation's PhotoconsistencyOdometryCeres).
Found by the configuration file's "backend" name (reference/vo.py)."""

from __future__ import annotations

import torch

from benchmark.reference import vo

# the preset keys this solver reads, besides those every solver reads;
# each must be given, one value a level
OPTIONS = {
    "function_tolerance": "function_tolerances",
    "gradient_tolerance": "gradient_tolerances",
    "parameter_tolerance": "parameter_tolerances",
    "initial_radius": "initial_trust_region_radii",
    "max_radius": "max_trust_region_radii",
    "min_radius": "min_trust_region_radii",
    "min_relative_decrease": "min_relative_decreases",
}
KEYS = tuple(OPTIONS.values())
SAMPLING = ("bilinear",)


def solve_level(state, packs, intr_l, H, W, cfg, level):
    opts = {k: cfg[f][level] for k, f in OPTIONS.items()}
    opts["max_iterations"] = cfg["max_iterations"][level]
    return tr_level(state, packs, intr_l, H, W, True, opts)


def tr_level(state, packs, intr_l, H, W, bilinear, opts):
    """Ceres's trust-region Levenberg-Marquardt on one level: the step
    solves (JtJ + diag(JtJ)/radius) dx = -Jtr; a trial is accepted when the
    actual over the predicted decrease of 0.5 sum r^2 exceeds
    min_relative_decrease; the radius grows as radius / max(1/3, 1 - (2 rho
    - 1)^3) on acceptance (at most max_radius) and halves on rejection; a
    pair stops on the function, gradient or parameter tolerance, a radius
    under min_radius, or its budget. Returns (state, iterations,
    num_valid)."""
    B = state.shape[0]
    dev = state.device
    f32 = lambda v: torch.tensor(float(v), dtype=torch.float32, device=dev)  # noqa: E731
    ftol, gtol, ptol = f32(opts["function_tolerance"]), f32(opts["gradient_tolerance"]), f32(
        opts["parameter_tolerance"])
    rmax, rmin, mrd = f32(opts["max_radius"]), f32(opts["min_radius"]), f32(opts["min_relative_decrease"])
    JtJ, Jtr, cost_raw, nvalid = vo.linearize(state, *packs, intr_l, H, W, bilinear)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    radius = f32(opts["initial_radius"]).expand(B)
    done = Jtr.abs().amax(1) <= gtol
    while True:
        act = (it < opts["max_iterations"]) & ~done
        if not bool(act.any()):
            break
        cost = 0.5 * cost_raw
        d = torch.diagonal(JtJ, dim1=1, dim2=2)
        A = JtJ + torch.diag_embed(d.clamp(1e-12, 1e32) * (1.0 / radius)[:, None])
        step = vo.chol_solve6(A, -Jtr)
        step = torch.where(torch.isfinite(step).all(1, keepdim=True), step, 0.0)
        trial = state + step
        JtJ_n, Jtr_n, cost_n_raw, nvalid_n = vo.linearize(trial, *packs, intr_l, H, W, bilinear)
        new_cost = 0.5 * cost_n_raw
        sAs = torch.zeros_like(cost)
        for i in range(6):
            for j in range(6):
                sAs = sAs + step[:, i] * JtJ[:, i, j] * step[:, j]
        predicted = torch.clamp(-vo.dot6(step, Jtr) - 0.5 * sAs, min=1e-30)
        rho = (cost - new_cost) / predicted
        accept = rho > mrd
        t = 2.0 * rho - 1.0
        grow = radius / torch.clamp(1.0 - t * t * t, min=1.0 / 3.0)
        new_radius = torch.where(accept, torch.minimum(grow, rmax), radius * 0.5)
        x2, s2 = vo.dot6(state, state), vo.dot6(step, step)
        upd = act & accept
        state = torch.where(upd[:, None], trial, state)
        JtJ = torch.where(upd[:, None, None], JtJ_n, JtJ)
        Jtr = torch.where(upd[:, None], Jtr_n, Jtr)
        cost_raw = torch.where(upd, cost_n_raw, cost_raw)
        nvalid = torch.where(upd, nvalid_n, nvalid)
        f_done = accept & ((cost - new_cost).abs() <= ftol * cost)
        g_done = Jtr.abs().amax(1) <= gtol
        p_done = accept & (s2.sqrt() <= ptol * (x2.sqrt() + ptol))
        done = torch.where(act, f_done | g_done | p_done | (new_radius < rmin), done)
        radius = torch.where(act, new_radius, radius)
        it = it + act.long()
    return state, it, nvalid
