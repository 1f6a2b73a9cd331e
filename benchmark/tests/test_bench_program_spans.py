"""The program's spans in a traced window (benchmark/program_spans.py): on
a hand-written Chrome trace every number is exact, reduce reads the same
with and without the `phovo.*` events, and a traced CPU run of each cell
carries the spans its path runs."""

import pytest

from benchmark import program_spans, run, tracing
from benchmark.tests.helpers import small_run

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
MAIN, OTHER = (1, 1), (1, 2)  # (pid, tid)


def _span(name, ts, dur, thread=MAIN):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "pid": thread[0], "tid": thread[1]}


def _launch(corr, ts, thread=MAIN, name="cudaLaunchKernel"):
    return {"cat": "cuda_runtime", "name": name, "ts": ts, "dur": 0.5, "pid": thread[0], "tid": thread[1],
            "args": {"correlation": corr}}


def _device(corr, ts, dur, cat="kernel", name="k"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7, "args": {"correlation": corr}}


# microseconds; the window is [0, 100)
HARNESS = [
    _span(tracing.WINDOW_SPAN, 0, 100),
    _span("align call", 8, 54),
    _launch(1, 11), _device(1, 40, 4),  # from phovo.align's self time
    _launch(2, 14), _device(2, 15, 3),  # from the outer phovo.prep
    _launch(3, 22), _device(3, 23, 4),  # from the phovo.prep nested in it
    _launch(4, 36, name="cudaLaunchKernelExC"), _device(4, 45, 13, name="fused_tr_batch_kernel"),  # phovo.level
    _launch(5, 65), _device(5, 66, 2),  # outside every span
    _device(99, 90, 2),  # no launch in the trace
    _launch(6, 71, name="cudaMemcpyAsync"), _device(6, 72, 7, cat="gpu_memcpy", name="Memcpy HtoD"),
    _launch(7, 37, thread=OTHER), _device(7, 95, 1),  # another thread, in no span of its own
    _launch(8, -9), _device(8, -5, 2),  # before the window
]
PROGRAM = [
    _span("phovo.align", 10, 50),
    _span("phovo.prep", 12, 18),
    _span("phovo.prep", 20, 5),
    _span("phovo.level", 35, 15),
    _span("phovo.upload", 70, 10),
]


def test_attribution_on_a_hand_written_trace():
    got = program_spans.attribute(HARNESS + PROGRAM)
    want = {
        # self [10, 12] + [30, 35] + [50, 60]; idle [10, 12], [30, 35], [58, 60]
        "phovo.align": {"spans": 1, "host_s": 17, "launches": 1, "device_s": 4, "idle_s": 9},
        # self [12, 20] + [25, 30] and [20, 25]; idle [12, 15], [18, 20], [27, 30] and [20, 23]
        "phovo.prep": {"spans": 2, "host_s": 18, "launches": 2, "device_s": 7, "idle_s": 11},
        # self [35, 50]; idle [35, 40], [44, 45]
        "phovo.level": {"spans": 1, "host_s": 15, "launches": 1, "device_s": 13, "idle_s": 6},
        # self [70, 80]; idle [70, 72], [79, 80]
        "phovo.upload": {"spans": 1, "host_s": 10, "launches": 0, "device_s": 0, "idle_s": 3},
        program_spans.OUTSIDE: {"launches": 2, "device_s": 3},
        program_spans.UNATTRIBUTED: {"launches": 1, "device_s": 2},
    }
    assert set(got) == set(want)
    for name, row in want.items():
        assert set(got[name]) == set(row), name
        for key, value in row.items():
            scale = 1e-6 if key.endswith("_s") else 1
            assert got[name][key] == pytest.approx(value * scale, abs=1e-12), (name, key)
    kernels = sum(1 for e in HARNESS if e["cat"] == "kernel" and 0 <= e["ts"] < 100)
    assert sum(row["launches"] for row in got.values()) == kernels


def test_no_window_reads_nothing():
    assert program_spans.attribute(HARNESS[1:] + PROGRAM) == {}


def test_reduce_reads_the_same_with_the_program_spans():
    assert tracing.reduce(HARNESS + PROGRAM, run.SPANS) == tracing.reduce(HARNESS, run.SPANS)


# the spans each cell's path writes (models/base.py, models/analytic.py,
# models/autodiff.py, ops/fused.py, ops/fused_batch.py)
PATH_SPANS = {
    "analytic5.replay": {"phovo.align", "phovo.prep", "phovo.level"},
    "ceres5.replay": {"phovo.align", "phovo.prep", "phovo.level"},
    "ceres5.live": {"phovo.upload", "phovo.align", "phovo.prep", "phovo.level"},
    # a round on the CPU runs launch by launch (the card replays it as one
    # CUDA graph under phovo.replay)
    "analytic5.fleet": {"phovo.align", "phovo.prep", "phovo.level"},
}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_traced_run_carries_the_spans_of_its_path(cell, monkeypatch):
    """The window's events of a traced 60x80 run, as reduce receives them,
    hold each span the cell's path runs, with host time and no kernel
    (the CPU runs the plain twins)."""
    seen = []

    def keep(events, spans):
        seen.append(program_spans.attribute(events))
        return reduce(events, spans)

    reduce = tracing.reduce
    monkeypatch.setattr(tracing, "reduce", keep)
    rec = small_run(cell, seed=2**35 + 3, seconds=3.0, trace=True)
    assert rec["trace"]["frames"] > 0 and len(seen) == 1
    got = seen[0]
    assert {name for name in got if name.startswith(program_spans.PREFIX)} == PATH_SPANS[cell]
    for name in PATH_SPANS[cell]:
        assert got[name]["spans"] > 0 and got[name]["host_s"] > 0
    assert all(row["launches"] == 0 for row in got.values())
