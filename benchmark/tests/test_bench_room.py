"""Room for a keyframe cell: answers that start from a warm state, a back
end's keyframe poses and a window that ends with its pass, at 120x160 on
the CPU. A test-local driver runs KeyframeVisualOdometry.run_chunked(16)
and finalize with odometry alone (no loop closure, no BA), and a
test-local back end composes the odometry edges; both are registered
under the harness's names for this test alone, and no harness file is
edited (a copy of the checkout takes the new configuration, mix and
limits files). The driver reads each tracked frame's start by wrapping
the program module's track function: the program reports no starts, nor
its loop closures' answers, yet."""

import json
import sys
import time
import types

import numpy as np
import pytest
import torch

from benchmark import check, drivers, run
from benchmark.reference import vo as reference
from benchmark.tests.helpers import small_run
from benchmark.tests.test_bench_layout import _copy_checkout

CELL, CONFIG, MIX, BACKEND = "analytic5.kfroom", "tum_fr1_analytic5_kfroom", "kfroom", "kfroom_compose"
# 96 frames at 120x160, keyframes past 0.08 m or 0.08 rad: five keyframes,
# half the frames in chunks of 16 that start warm. At 60x80 the 15x20
# level's answers scatter by some 0.05 from frame to frame, a keyframe
# follows every few frames, and no chunk of 16 runs to its end warm.
ROOM_SIZE = {"frames": 96, "shape": (120, 160)}
KF_LIMITS = {"state_gap_median": 1e-5, "state_gap": 1e-4, "iters_differ": 0.03, "pose_gap": 0.03,
             "keyframe_pose_gap": 1e-4, "missing": 0}


def drive(prog, seq, mix, seconds, tracer, rng):
    """Whole passes of the sequence through run_chunked(mix["chunk"]) and
    finalize, until `seconds` have passed at the end of a pass; each
    pass is one chain whose answers are the tracked frames' (each from the
    state its chunk started at) and whose keyframes are finalize's."""
    del tracer, rng
    I8, D16 = seq
    entries = prog.entries
    kvo_cls, frame_cls = drivers._resolve(entries["keyframe_api"]), drivers._resolve(entries["frame_type"])
    module = sys.modules[kvo_cls.__module__]
    track = getattr(module, entries["keyframe_track"])
    dispatches = []

    def recorded(*a, **k):  # the track function run_chunked calls
        res = track(*a, **k)
        dispatches.append({"inits": a[3].cpu().numpy(), "res": res, "used": 0})
        return res

    def one_pass():
        kvo = kvo_cls(prog.object_api(), **mix["keyframe"])
        frames = (frame_cls(timestamp=k / 30.0, depth_timestamp=k / 30.0, intensity=I8[k], depth=D16[k])
                  for k in range(len(I8)))
        chain, rows = drivers.Chain(), {}
        for tf in kvo.run_chunked(frames, chunk=int(mix["chunk"]), depth_scale=prog.depth_scale):
            d = dispatches[-1]
            k, d["used"] = d["used"], d["used"] + 1
            res = d["res"]
            src = kvo.keyframes[tf.keyframe_index].frame_index
            rows[(src, tf.frame_index)] = len(chain.pairs)
            state = res.state[k].cpu().numpy()
            poses, chain.pose = drivers.integrate(chain.pose, state[None])
            chain.add([(src, tf.frame_index)], state, poses, res.iterations[k:k + 1], res.num_valid[k:k + 1],
                      inits=d["inits"][k:k + 1])
        kvo.finalize(ba_iterations=int(mix["ba_iterations"]))
        kfs = kvo.keyframes
        chain.keyframes = {
            "frames": [kf.frame_index for kf in kfs],
            "edges": [(i, j, rows[(kfs[i].frame_index, kfs[j].frame_index)]) for i, j, _ in kvo.odometry_edges],
            "weights": [1.0] * len(kvo.odometry_edges),
            "poses": np.stack([kf.pose for kf in kfs]),
        }
        return chain

    setattr(module, entries["keyframe_track"], recorded)
    try:
        one_pass()  # the warm-up: every shape of a pass
        chains, t_start = [], time.perf_counter()
        while not chains or time.perf_counter() < t_start + seconds:
            chains.append(one_pass())
        window = time.perf_counter() - t_start
    finally:
        setattr(module, entries["keyframe_track"], track)
    n = sum(len(c.pairs) for c in chains)
    return {"t_start": t_start, "window_s": window, "frames_done": n, "chains": chains, "calls": [],
            "attempted": n, "missing": 0, "latencies": None}


def solve(graph, answers, seq, config, device):
    """The keyframe poses the odometry edges compose to, in edge order,
    from the first keyframe at the identity."""
    del seq, config, device
    poses = np.zeros((len(graph["frames"]), 4, 4))
    poses[0] = np.eye(4)
    for (i, j, _), state in zip(graph["edges"], answers[0]):
        poses[j] = poses[i] @ np.linalg.inv(reference.pose_matrix(state))
    return poses


@pytest.fixture
def room(tmp_path, monkeypatch):
    """A copy of the checkout with the keyframe cell's files and entries,
    and the driver and back end under their harness names."""
    root, bench = _copy_checkout(tmp_path)
    bench_dir = root / "benchmark"
    config = json.loads((bench_dir / "configs" / "tum_fr1_analytic5.json").read_text())
    config["name"] = CONFIG
    config["reference_backend"] = BACKEND
    config["program"].update(keyframe_api="phovo_tpu_torch.models.keyframe.KeyframeVisualOdometry",
                             frame_type="phovo_tpu_torch.datasets.tum.RGBDFrame",
                             keyframe_track="track_chunk_levelmajor")
    (bench_dir / "configs" / f"{CONFIG}.json").write_text(json.dumps(config))
    mix = json.loads((bench_dir / "traffic" / "replay.json").read_text())
    mix.update(driver="kfroom", chunk=16, ba_iterations=0,
               keyframe={"kf_translation": 0.08, "kf_rotation": 0.08, "loop_min_gap": 10**6})
    (bench_dir / "traffic" / f"{MIX}.json").write_text(json.dumps(mix))
    (bench_dir / "limits" / f"{CELL}.json").write_text(json.dumps(KF_LIMITS))
    bench["configs"].append({"name": CONFIG, "source": "a test", "file": f"benchmark/configs/{CONFIG}.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": CELL, "config": CONFIG, "traffic": MIX, "chips": 1, "why": "a test"})
    next(m for m in bench["end_to_end"] if m["name"] == "frames_per_s")["workloads"].append(CELL)
    monkeypatch.setitem(sys.modules, "benchmark.drivers.kfroom", types.SimpleNamespace(drive=drive))
    monkeypatch.setitem(sys.modules, f"benchmark.reference.{BACKEND}", types.SimpleNamespace(solve=solve))
    before = {p: p.read_bytes() for p in (run.ROOT / "benchmark").rglob("*.py")}
    yield root, bench
    assert all(p.read_bytes() == b for p, b in before.items())


def _room_run(room, seed=2**34 + 21):
    """One pass of ROOM_SIZE through the keyframe cell of the copy."""
    root, bench = room
    return small_run(CELL, seed=seed, seconds=0.0, root=root, bench=bench, keep=True, extra=ROOM_SIZE)


def _rejudge(rec, chains):
    """The check's numbers and verdict on `chains` in place of the run's."""
    uniq = check.distinct_pairs(chains)
    ref = check.reference_answers(uniq, rec["seq"], rec["config"], torch.device("cpu"))
    numbers = check.compare(chains, ref, uniq, rec["config"], 0)
    numbers.update(check.backend_numbers(chains, ref, uniq, rec["seq"], rec["config"], torch.device("cpu")))
    return numbers, check.judge(numbers, KF_LIMITS)[0]


def test_the_keyframe_pass_is_judged_from_its_warm_starts(room):
    """run_chunked(16) and finalize through the test-local driver: the
    answers started warm, the whole pass is the window, and the check
    judges the states, the starts and the keyframe poses correct."""
    rec = _room_run(room)
    assert rec["correct"], rec["checks"]
    (chain,) = rec["chains"]
    assert len(chain["pairs"]) == 95 and rec["frames_done"] == 95
    assert (np.abs(chain["inits"]).sum(axis=1) > 0).sum() > 10  # most frames start warm
    kf = chain["keyframes"]
    assert len(kf["frames"]) >= 3 and len(kf["edges"]) == len(kf["frames"]) - 1
    assert rec["numbers"]["keyframe_pose_gap"] <= KF_LIMITS["keyframe_pose_gap"]
    assert set(rec["checks"]) == set(KF_LIMITS)
    # the rate reads the pass's true window, not the seconds asked for
    line = run.result_line(room[1], CELL, rec, False, {"platform": "cpu"}, root=room[0])
    assert rec["seconds"] > 0.0
    assert line["metrics"]["frames_per_s"]["value"] == pytest.approx(95 / rec["seconds"])


def test_a_warm_answer_judged_from_zero_or_moved_is_not_correct(room):
    rec = _room_run(room)
    (chain,) = rec["chains"]
    warm = int(np.flatnonzero(np.abs(chain["inits"]).sum(axis=1) > 0)[-1])
    numbers, ok = _rejudge(rec, rec["chains"])
    assert ok and numbers["state_gap"] == rec["numbers"]["state_gap"]
    # the reference asked to start one warm answer from zero
    dropped = dict(chain, inits=chain["inits"].copy())
    dropped["inits"][warm] = 0.0
    numbers, ok = _rejudge(rec, [dropped])
    assert not ok and numbers["state_gap"] > KF_LIMITS["state_gap"], numbers
    # one answer's state moved by 1e-3
    moved = dict(chain, states=chain["states"].copy())
    moved["states"][warm, 0] += 1e-3
    numbers, ok = _rejudge(rec, [moved])
    assert not ok and numbers["state_gap"] > KF_LIMITS["state_gap"], numbers


def test_a_keyframe_pose_off_its_edges_is_not_correct(room):
    rec = _room_run(room)
    (chain,) = rec["chains"]
    kf = chain["keyframes"]
    bad = dict(chain, keyframes=dict(kf, poses=kf["poses"].copy()))
    bad["keyframes"]["poses"][1][0, 3] += 1e-2
    numbers, ok = _rejudge(rec, [bad])
    assert not ok and numbers["keyframe_pose_gap"] > KF_LIMITS["keyframe_pose_gap"], numbers
    # a chain that carries no keyframes, where the configuration asks for them
    numbers, ok = _rejudge(rec, [{k: v for k, v in chain.items() if k != "keyframes"}])
    assert not ok and numbers["keyframe_pose_gap"] == float("inf")


@pytest.mark.parametrize("cell", [w["name"] for w in run.load_json(run.ROOT / "BENCHMARK.json")["workloads"]])
def test_zero_starts_give_the_zero_start_numbers(cell):
    """Every cell's chains start at zero, and the check's numbers are those
    of answers keyed on their frame pairs alone and a reference that starts
    every pair from torch.zeros, as before starts were keyed, bit for bit."""
    rec = small_run(cell, seed=2**36 + 7, keep=True)
    assert all((ch["inits"] == 0).all() for ch in rec["chains"])
    pairs = np.unique(np.concatenate([ch["pairs"] for ch in rec["chains"] if len(ch["pairs"])]), axis=0)
    assert (rec["uniq"][:, :2] == pairs).all() and (rec["uniq"][:, 2:] == 0).all()
    I8, D16 = rec["seq"]
    zero = reference.align_pairs(I8[pairs[:, 0]], D16[pairs[:, 0]], I8[pairs[:, 1]], D16[pairs[:, 1]],
                                 check.reference_config(rec["config"]), torch.device("cpu"))
    assert all((a == b).all() for a, b in zip(zero, rec["ref"]))
    chains = [{k: v for k, v in ch.items() if k != "inits"} for ch in rec["chains"]]
    numbers = check.compare(chains, zero, check.answer_keys(pairs), rec["config"], rec["missing"])
    assert {k: numbers[k] for k in check.NUMBERS if k in numbers} == \
        {k: rec["numbers"][k] for k in check.NUMBERS if k in rec["numbers"]}
    assert "keyframe_pose_gap" not in rec["numbers"]


def test_the_line_carries_the_host_state_last_but_the_checks():
    rec = small_run("analytic5.replay", seed=2**36 + 9)
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    line = run.result_line(bench, "analytic5.replay", rec, False, {"platform": "cpu"})
    assert list(line)[-2:] == ["host", "checks"]
    for end in ("start", "end"):
        got = line["host"][end]
        assert got["load1"] >= 0 and got["affinity"] and got["cpu"] is not None
        assert got["sm_mhz"] is None  # no card
