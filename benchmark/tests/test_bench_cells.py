"""Every cell runs at 60x80 on the CPU through the port's plain twins, its
result line parses, and its answers match the reference."""

import json

import pytest

from benchmark import run
from benchmark.tests.helpers import small_run

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
# cells whose CPU path computes the reference's batched sums, bit for bit
EXACT = {"analytic5.replay", "ceres5.replay"}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_its_line_parses(cell, trace):
    # a window long enough that a loaded CPU still settles a chunk in it
    rec = small_run(cell, seed=2**33 + 11, seconds=3.0, trace=bool(trace))
    line = json.loads(json.dumps(run.result_line(BENCH, cell, rec, bool(trace), {"platform": "cpu"})))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["attempted"] > 0 and line["failed"] == 0
    if cell in EXACT:
        assert line["correct"] is True, line["checks"]
    else:
        # a pair alone rounds its batched sums apart from the reference's
        # blocks, and at 60x80 the 4x5 level of a few pairs has almost no
        # valid pixel, where that rounding sends the trust region anywhere:
        # the typical answer is held, not the widest
        assert line["checks"]["state_gap_median"]["value"] <= line["checks"]["state_gap_median"]["limit"]
    if not trace:
        assert "setup_s" in line["metrics"]
        assert len(line["metrics"]) >= 2
    assert rec["numbers"]["answers"] > 0


def test_same_seed_same_frames():
    import torch

    from benchmark.traffic.generator import make_sequence

    _, config, mix, _ = run.cell_files(BENCH, "analytic5.replay")
    run.apply_overrides(config, mix, {"shape": (60, 80), "frames": 12})
    a = make_sequence(mix["scene"], config["camera"], 2**40 + 3, torch.device("cpu"))
    b = make_sequence(mix["scene"], config["camera"], 2**40 + 3, torch.device("cpu"))
    c = make_sequence(mix["scene"], config["camera"], 2**40 + 4, torch.device("cpu"))
    assert all((x == y).all() for x, y in zip(a, b))
    assert not (a[0] == c[0]).all()
    assert a[0].dtype.name == "uint8" and a[1].dtype.name == "uint16"
    assert (a[1] > 0).mean() > 0.5


def test_camera_path_keeps_the_named_speeds():
    import math

    import torch

    from benchmark.traffic.generator import _mean_speeds, camera_path

    gen = torch.Generator().manual_seed(5)
    T = camera_path(1352, 30.0, 0.33, 30.0, gen, torch.device("cpu"))
    R_wc = T[:, :3, :3].transpose(-1, -2)
    centres = -(R_wc @ T[:, :3, 3:])[..., 0]
    step, turn = _mean_speeds(centres, R_wc)
    assert abs(step * 30.0 - 0.33) < 1e-3
    assert abs(math.degrees(turn) * 30.0 - 30.0) < 0.05
