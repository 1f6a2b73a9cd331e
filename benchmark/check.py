"""How `correct` is decided: every answer the window produced against the
plain reference (benchmark/reference/vo.py), run once the window has
closed on the same uint8 and uint16 frames.

The numbers a cell compares are those its file under benchmark/limits/
gives a limit; the check computes them all:
  * state_gap_median: the median over every answer of the gap between a
    pair's state and the reference's (largest absolute difference of the
    six components: metres and radians);
  * state_gap: the widest such gap;
  * iters_differ: the share of answers whose iteration count differs from
    the reference's at some level that has a budget;
  * valid_gap: the widest relative gap between a pair's valid-pixel count
    and the reference's, at a level that has a budget;
  * pose_gap: the widest gap, over every chain, between a global pose the
    harness integrated from the program's states and the pose the
    reference integrates from its own (largest absolute difference of the
    4x4 entries);
  * missing: the frames due in the window that got no pose.
Numbers with no limit in the cell's file are printed and not judged: a
widest gap whose readings on sound runs come within three times of the
control's has no place between them (PERF.md gives the readings).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import vo as reference

NUMBERS = ("state_gap_median", "state_gap", "iters_differ", "valid_gap", "pose_gap", "missing")


def reference_config(config: dict) -> dict:
    """The reference's view of a configuration file: its backend and
    preset as they stand, the float32 intrinsics and the depth scale."""
    cam = config["camera"]
    return {
        "backend": config["backend"],
        "preset": dict(config["preset"]),
        "intrinsics": tuple(float(np.float32(cam[k])) for k in ("fx", "fy", "cx", "cy")),
        "depth_scale": 1.0 / float(cam["depth_counts_per_m"]),
    }


def reference_answers(pairs: np.ndarray, seq, config: dict, device, pack_dtype=torch.float32):
    """The reference's (states, iterations, num_valid) of each (source,
    target) frame pair in `pairs` ((P, 2) frame indices)."""
    I8, D16 = seq
    return reference.align_pairs(I8[pairs[:, 0]], D16[pairs[:, 0]], I8[pairs[:, 1]], D16[pairs[:, 1]],
                                 reference_config(config), device, pack_dtype)


def compare(chains: list[dict], ref, uniq: np.ndarray, config: dict, missing: int) -> dict:
    """The numbers of the module docstring from the program's chains and
    the reference's answers `ref` to the distinct pairs `uniq`."""
    ref_states, ref_its, ref_valid = ref
    active = np.asarray(config["preset"]["max_iterations"]) > 0
    lookup = {tuple(p): i for i, p in enumerate(uniq.tolist())}
    gaps, differ, vgaps, pose_gaps, n = [], 0, [], [], 0
    ref_chains = {}
    for ch in chains:
        if not len(ch["pairs"]):
            continue
        at = np.array([lookup[tuple(p)] for p in ch["pairs"].tolist()])
        gaps.append(np.abs(ch["states"].astype(np.float64) - ref_states[at]).max(axis=1))
        differ += int((ch["iterations"][:, active] != ref_its[at][:, active]).any(axis=1).sum())
        rv = ref_valid[at][:, active].astype(np.float64)
        vgaps.append((np.abs(ch["num_valid"][:, active] - rv) / np.maximum(rv, 1.0)).max(axis=1))
        key = tuple(at.tolist())
        if key not in ref_chains:
            ref_chains[key] = reference.integrate(ref_states[at])
        pose_gaps.append(np.abs(ch["poses"] - ref_chains[key]).max())
        n += len(at)
    gap = np.concatenate(gaps) if gaps else np.zeros(0)
    return {
        "state_gap": float(gap.max()) if n else float("inf"),
        "iters_differ": differ / max(n, 1),
        "valid_gap": float(np.concatenate(vgaps).max()) if n else float("inf"),
        "pose_gap": float(max(pose_gaps)) if pose_gaps else float("inf"),
        "missing": int(missing),
        "state_gap_median": float(np.median(gap)) if n else float("inf"),
        # the look: how the state gaps spread over the answers
        "state_gap_p99": float(np.quantile(gap, 0.99)) if n else float("inf"),
        "answers": n,
    }


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every limited number within its limit, {name: {value, limit}} in
    NUMBERS order)."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS if k in limits}
    ok = all(v["value"] <= v["limit"] for v in shown.values()) and bool(shown)
    return ok, shown


def distinct_pairs(chains: list[dict]) -> np.ndarray:
    pairs = [ch["pairs"] for ch in chains if len(ch["pairs"])]
    if not pairs:
        return np.zeros((0, 2), np.int64)
    return np.unique(np.concatenate(pairs), axis=0)
