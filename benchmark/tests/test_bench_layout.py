"""The harness finds every cell's configuration, traffic mix, limits and
metric readers by name, and a later PR can add a cell with new files and
entries alone."""

import json
import re
import shutil

import pytest

from benchmark import drivers, run
from benchmark.tests.helpers import small_run

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    entry, config, mix, limits = run.cell_files(BENCH, cell)
    assert entry["name"] == cell
    assert config["name"] == entry["config"]
    assert callable(drivers.find(mix["driver"]))
    assert limits, f"benchmark/limits/{cell}.json is missing or empty"
    for trace in (False, True):
        for m in run.cell_metrics(BENCH, cell, trace):
            assert callable(run.load_reader(m["name"]))


def test_names_and_keys_follow_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]
    for c in BENCH["configs"]:
        assert (run.ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in run.cell_metrics(BENCH, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.cell_metrics(BENCH, w["name"], True)


DUMMIES = {
    # a replay with a slower camera, and a live camera at half the rate
    "slow_turn": ("replay", {"chunk": 3}, {"turn_deg_s": 10.0}, "frames_per_s"),
    "half_rate_camera": ("live", {"fps": 15}, {}, "latency_p95_ms"),
}


def _copy_checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(run.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root, json.loads((run.ROOT / "BENCHMARK.json").read_text())


def _add_cell(root, bench, mix_name, driver, params, scene, metric):
    """A new traffic file, a new limits file and a new workload entry."""
    mix = json.loads((root / "benchmark" / "traffic" / f"{driver}.json").read_text())
    mix.update(params)
    mix["scene"].update(scene)
    (root / "benchmark" / "traffic" / f"{mix_name}.json").write_text(json.dumps(mix))
    cell = f"analytic5.{mix_name}"
    (root / "benchmark" / "limits" / f"{cell}.json").write_text(
        (root / "benchmark" / "limits" / "analytic5.replay.json").read_text())
    bench["workloads"].append({"name": cell, "config": "tum_fr1_analytic5", "traffic": mix_name, "chips": 1,
                               "why": "a dummy cell of the test"})
    next(m for m in bench["end_to_end"] if m["name"] == metric)["workloads"].append(cell)
    return cell


@pytest.mark.parametrize("mix_name", sorted(DUMMIES))
def test_a_new_mix_and_cell_need_only_new_files_and_entries(tmp_path, mix_name):
    """A dummy mix in a copy of the benchmark, and no existing file
    edited."""
    driver, params, scene, metric = DUMMIES[mix_name]
    root, bench = _copy_checkout(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    cell = _add_cell(root, bench, mix_name, driver, params, scene, metric)
    rec = small_run(cell, root=root, bench=bench, extra=params)
    line = run.result_line(bench, cell, rec, False, {"platform": "cpu"}, root=root)
    assert line["correct"], line["checks"]
    assert metric in line["metrics"] and rec["attempted"] > 0 and rec["missing"] == 0
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_new_per_layer_metric_needs_only_a_reader_and_an_entry(tmp_path):
    """A dummy reader file and a per_layer entry: a traced run reports it,
    and an untraced one does not."""
    root, bench = _copy_checkout(tmp_path)
    (root / "benchmark" / "metrics" / "traced_frames.replay.py").write_text(
        "def read(record):\n    t = record.get('trace')\n    return float(t['frames']) if t else None\n")
    bench["per_layer"].append({"name": "traced_frames.replay", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "host dispatch", "moves": "frames_per_s",
                               "workloads": ["analytic5.replay"]})
    rec = small_run("analytic5.replay", root=root, bench=bench, trace=True)
    line = run.result_line(bench, "analytic5.replay", rec, True, {"platform": "cpu"}, root=root)
    assert line["metrics"]["traced_frames.replay"]["value"] > 0
    assert "traced_frames.replay" not in run.result_line(bench, "analytic5.replay", rec, False,
                                                         {"platform": "cpu"}, root=root)["metrics"]
