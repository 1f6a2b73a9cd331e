"""Each cell through the command on the card, a short window: exit 0, a
parsing last line, `correct` true, the cell's metrics present."""

import json
import subprocess
import sys

import pytest

from benchmark import run

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card(card, cell, trace):
    del card
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(2**32 + 17),
                          "--seconds", "3", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=900, cwd=str(run.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["memory_peak_bytes"] > 0
    names = {m["name"] for m in run.cell_metrics(BENCH, cell, bool(trace))}
    assert set(line["metrics"]) <= names and line["metrics"]
    if trace:
        assert line["device"]["busy_s"] > 0 and line["breakdown"]["device_ops"]
