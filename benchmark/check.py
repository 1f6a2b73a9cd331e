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
  * keyframe_pose_gap: where the configuration names a
    "reference_backend", the widest gap between a back end's keyframe
    poses that a chain carries (drivers.Chain.keyframes) and the poses
    benchmark/reference/<reference_backend>.py makes of the reference's
    answers to the same graph edges;
  * missing: the frames due in the window that got no pose.
An answer is the alignment of a (source, target) frame pair from the
state it started at: the reference answers each distinct (source,
target, start) once, keyed on the start's float32 bits, from that start.
Numbers with no limit in the cell's file are printed and not judged: a
widest gap whose readings on sound runs come within three times of the
control's has no place between them (PERF.md gives the readings).
"""

from __future__ import annotations

import importlib
import re

import numpy as np
import torch

from benchmark.reference import vo as reference

NUMBERS = ("state_gap_median", "state_gap", "iters_differ", "valid_gap", "pose_gap", "keyframe_pose_gap", "missing")


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


def answer_keys(pairs: np.ndarray, inits: np.ndarray | None = None) -> np.ndarray:
    """(n, 8) int64 keys of answers: source, target and the six float32
    bit patterns of the state each started from (zeros where None)."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    if inits is None:
        inits = np.zeros((len(pairs), 6), np.float32)
    bits = np.ascontiguousarray(inits, np.float32).reshape(-1, 6).view(np.uint32).astype(np.int64)
    return np.concatenate([pairs, bits], axis=1)


def key_inits(keys: np.ndarray) -> np.ndarray:
    """(P, 6) float32 starts of answer keys; (P, 2) frame pairs start at
    zero."""
    if keys.shape[1] == 2:
        return np.zeros((len(keys), 6), np.float32)
    return np.ascontiguousarray(keys[:, 2:]).astype(np.uint32).view(np.float32)


def reference_answers(keys: np.ndarray, seq, config: dict, device, pack_dtype=torch.float32):
    """The reference's (states, iterations, num_valid) of each answer key
    in `keys` ((P, 8) from answer_keys, or (P, 2) frame pairs from zero)."""
    I8, D16 = seq
    src, tgt = keys[:, 0], keys[:, 1]
    return reference.align_pairs(I8[src], D16[src], I8[tgt], D16[tgt], reference_config(config), device,
                                 pack_dtype, inits=key_inits(keys))


def key_rows(uniq: np.ndarray) -> dict:
    """Answer key -> its row of `uniq`."""
    return {tuple(k): i for i, k in enumerate(uniq.tolist())}


def rows_of(rows: dict, chain: dict) -> np.ndarray:
    """The row (key_rows) of each of a chain's answers."""
    return np.array([rows[tuple(k)] for k in answer_keys(chain["pairs"], chain.get("inits")).tolist()], np.int64)


def compare(chains: list[dict], ref, uniq: np.ndarray, config: dict, missing: int) -> dict:
    """The numbers of the module docstring from the program's chains and
    the reference's answers `ref` to the distinct pairs `uniq`."""
    ref_states, ref_its, ref_valid = ref
    active = np.asarray(config["preset"]["max_iterations"]) > 0
    rows = key_rows(uniq)
    gaps, differ, vgaps, pose_gaps, n = [], 0, [], [], 0
    ref_chains = {}
    for ch in chains:
        if not len(ch["pairs"]):
            continue
        at = rows_of(rows, ch)
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


def backend(name: str):
    """The back end's reference, benchmark/reference/<name>.py, by name:
    its solve(graph, answers, seq, config, device) takes a chain's
    keyframe graph ({"frames", "edges", "weights"} as drivers.Chain
    holds them) and the reference's (states, iterations, num_valid) of
    each edge's answer, and returns the (K, 4, 4) keyframe poses."""
    if not re.fullmatch(r"[a-z][A-Za-z0-9_]*", name):
        raise ValueError(f"no reference back end named {name!r}")
    module = importlib.import_module(f"benchmark.reference.{name}")
    if not hasattr(module, "solve"):
        raise ValueError(f"benchmark/reference/{name}.py has no solve")
    return module


def backend_numbers(chains: list[dict], ref, uniq: np.ndarray, seq, config: dict, device) -> dict:
    """{"keyframe_pose_gap": ...} where the configuration names a
    "reference_backend" (inf where no chain carries keyframes), else {}."""
    name = config.get("reference_backend")
    if not name:
        return {}
    solve, rows = backend(name).solve, key_rows(uniq)
    gaps = []
    for ch in chains:
        kf = ch.get("keyframes")
        if kf is None:
            continue
        edge_rows = rows_of(rows, ch)[kf["edges"][:, 2]]
        answers = tuple(a[edge_rows] for a in ref)
        graph = {k: kf[k] for k in ("frames", "edges", "weights")}
        poses = np.asarray(solve(graph, answers, seq, config, device), np.float64)
        gaps.append(float(np.abs(kf["poses"] - poses).max()) if len(poses) else 0.0)
    return {"keyframe_pose_gap": max(gaps) if gaps else float("inf")}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every limited number within its limit, {name: {value, limit}} in
    NUMBERS order); a limited number the run did not compute is inf."""
    shown = {k: {"value": numbers.get(k, float("inf")), "limit": limits[k]} for k in NUMBERS if k in limits}
    ok = all(v["value"] <= v["limit"] for v in shown.values()) and bool(shown)
    return ok, shown


def distinct_pairs(chains: list[dict]) -> np.ndarray:
    """The distinct answer keys (answer_keys) of every chain, sorted."""
    keys = [answer_keys(ch["pairs"], ch.get("inits")) for ch in chains if len(ch["pairs"])]
    if not keys:
        return np.zeros((0, 8), np.int64)
    return np.unique(np.concatenate(keys), axis=0)
