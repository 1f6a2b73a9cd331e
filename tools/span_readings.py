#!/usr/bin/env python3
"""The program's spans (utils/profiling.span) read on the card: what the
benchmark's cells show when their traced window is split by phovo.upload,
phovo.align, phovo.prep, phovo.level and phovo.replay (the object API's
replayed pair graph), and what the spans and the profiler cost.

    python3 tools/span_readings.py trace --workload ceres5.live --seeds 7 8 --seconds 20
    python3 tools/span_readings.py trace --workload analytic5.fleet --seeds 7 --seconds 20
    python3 tools/span_readings.py cost [--pairs 40] [--chunks 4] [--rounds 3]

trace runs a cell as `benchmark/run.py --trace 1` does (benchmark.run.run_cell)
and prints one JSON line a seed: benchmark/program_spans.attribute of the
traced window, the per-frame readings taken from it (launches, device and
idle ms under each span; `frames` as the benchmark's readers count them),
the benchmark's own launches a frame beside them, the CUDA graphs' captures
and replays over the whole run (models/base: the object API's pairs and the
serving rounds) beside the window's calls, and for an open-loop cell the
latencies of the pairs (a fleet's: of the rounds, one a camera) started
before the traced window, inside it, and after it once they no longer
start late.

cost times, on the ceres5.live pair, on one 256-frame chunk of each
replay configuration and on one round of the analytic5.fleet cell's
cameras, the host time of a call (from its first call into
the program to its return; a pair's to its pose on the host too) with the
spans as they are and with span() replaced by a bare null context, each
with and without a profiler window around the calls; and the host cost of
one span() with no profiler running. --device cpu runs either at 60x80
for a rehearsal.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import drivers, program_spans, run, tracing  # noqa: E402

SMALL = {"shape": (60, 80), "frames": 12}
READINGS = {  # name: (span, field, scale to the unit)
    "prep_launches_per_frame": ("phovo.prep", "launches", 1.0),
    "level_launches_per_frame": ("phovo.level", "launches", 1.0),
    "replay_launches_per_frame": ("phovo.replay", "launches", 1.0),
    "glue_launches_per_frame": ("phovo.align", "launches", 1.0),
    "prep_device_ms_per_frame": ("phovo.prep", "device_s", 1e3),
    "prep_idle_ms_per_frame": ("phovo.prep", "idle_s", 1e3),
    "level_idle_ms_per_frame": ("phovo.level", "idle_s", 1e3),
    "replay_idle_ms_per_frame": ("phovo.replay", "idle_s", 1e3),
    "align_idle_ms_per_frame": ("phovo.align", "idle_s", 1e3),
    "upload_ms_per_frame": ("phovo.upload", "host_s", 1e3),
    "upload_idle_ms_per_frame": ("phovo.upload", "idle_s", 1e3),
}


def _device(name: str):
    import torch

    device = torch.device(name if name != "cuda" else "cuda:0")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def _quantiles(xs) -> dict:
    if len(xs) < 4:
        return {"n": len(xs)}
    ranked = sorted(xs)
    return {"n": len(xs), "p50_ms": 1e3 * statistics.median(ranked),
            "p95_ms": 1e3 * ranked[-(-95 * len(ranked) // 100) - 1]}


GRAPH_COUNTERS = ("GRAPH_CAPTURES", "GRAPH_REPLAYS", "ROUND_GRAPH_CAPTURES", "ROUND_GRAPH_REPLAYS")


def trace_runs(cell: str, seeds, seconds: float, device) -> list[dict]:
    """One traced run of `cell` a seed, with the program's spans attributed,
    the CUDA graphs' captures and replays over the run (warm-up included),
    and, for an open-loop cell, the latencies before, inside and after the
    window."""
    from phovo_tpu_torch.models import base

    bench = run.load_json(ROOT / "BENCHMARK.json")
    overrides = SMALL if device.type == "cpu" else None
    caught = {}
    reduce, find = tracing.reduce, drivers.find

    def keep_reduce(events, spans):
        caught["program"] = program_spans.attribute(events)
        return reduce(events, spans)

    def keep_find(name):
        drive = find(name)

        def wrapped(prog, seq, mix, secs, tracer, rng):
            out = drive(prog, seq, mix, secs, tracer, rng)
            caught["out"] = (tracer, out["t_start"], mix.get("fps"), [(c["t"], c["frames"]) for c in out["calls"]],
                             out["latencies"])
            return out

        return wrapped

    tracing.reduce, drivers.find = keep_reduce, keep_find
    lines = []
    try:
        for seed in seeds:
            caught.clear()
            graphs = {name: getattr(base, name) for name in GRAPH_COUNTERS}
            rec = run.run_cell(cell, seed, seconds, True, device, time.perf_counter(), bench, overrides)
            graphs = {name: getattr(base, name) - n for name, n in graphs.items()}
            t = rec.get("trace") or {}
            prog = caught.get("program", {})
            frames = t.get("frames", 0)
            kernels = sum(1 for cat, *_ in t.get("device_events", []) if cat == "kernel")
            line = {"cell": cell, "seed": seed, "correct": bool(rec["correct"]), "frames": frames,
                    "window_s": t.get("window_s"), "busy_s": t.get("busy_s"),
                    "launches_per_frame": kernels / frames if frames else None,
                    "kernels": kernels, "kernels_attributed": sum(r["launches"] for r in prog.values()),
                    "graphs": graphs, "calls": len(caught["out"][3]), "program": prog}
            for name, (span, field, scale) in READINGS.items():
                row = prog.get(span)
                line[name] = scale * row[field] / frames if row and frames else None
            tracer, t_start, fps, calls, latencies = caught["out"]
            if latencies is not None:
                # call k (a pair, or a fleet's round of one frame a camera)
                # is due k frame periods after the window opens, and each of
                # its frames has a latency; the trace's export when it stops
                # holds the host, and the calls after it queue until they
                # catch up: those that started late are left out after the
                # traced window
                due = [t_start + (k + 1) / fps for k, (_, n) in enumerate(calls) for _ in range(n)]
                starts = [t for t, n in calls for _ in range(n)]
                groups = {"before": [], "inside": [], "after": []}
                for s, d, lat in zip(starts, due, latencies):
                    if s < tracer.t0:
                        groups["before"].append(lat)
                    elif tracer.in_trace(s):
                        groups["inside"].append(lat)
                    elif s - d < 1e-3:
                        groups["after"].append(lat)
                line["latency"] = {k: _quantiles(v) for k, v in groups.items()}
            lines.append(line)
            print(json.dumps(line), flush=True)
    finally:
        tracing.reduce, drivers.find = reduce, find
    return lines


@contextlib.contextmanager
def _spans(on: bool):
    """The program's spans as they are (on), or span() replaced by a bare
    null context (off)."""
    from phovo_tpu_torch.utils import profiling

    real = profiling.span
    if not on:
        profiling.span = lambda name: profiling._NO_SPAN
    try:
        yield
    finally:
        profiling.span = real


@contextlib.contextmanager
def _profiler(on: bool, device):
    import torch

    if not on:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        yield


def cost(device, pairs: int, chunks: int, rounds: int, seed: int = 11) -> dict:
    """Host ms of a live pair and of a replay chunk with the spans on and
    off, with and without a profiler window; and ns of one span()."""
    import numpy as np
    import torch

    from benchmark.traffic.generator import make_sequence
    from phovo_tpu_torch.utils import profiling

    bench = run.load_json(ROOT / "BENCHMARK.json")
    cpu = device.type == "cpu"
    chunk = 4 if cpu else 256
    progs = {}
    for cell in ("ceres5.live", "analytic5.replay", "ceres5.replay", "analytic5.fleet"):
        _, config, mix, _ = run.cell_files(bench, cell)
        run.apply_overrides(config, mix, dict(SMALL, frames=max(pairs, chunk) + 1) if cpu
                            else {"frames": max(pairs, chunk) + 1})
        progs[cell] = drivers.Program(config, device)
        if cell == "analytic5.fleet":
            cameras = int(mix["cameras"])
    if not cpu:
        progs["ceres5.live"].load_kernels()
    # the three configurations share the camera: one sequence serves all
    I8, D16 = make_sequence(mix["scene"], config["camera"], seed, device)

    def sync():
        if not cpu:
            torch.cuda.synchronize(device)

    live = progs["ceres5.live"]
    vo = live.object_api()
    depth_m = [d.astype(np.float32) * np.float32(live.depth_scale) for d in D16[:pairs + 1]]
    zero = np.zeros(6, np.float32)

    def alternate(n, first_on, one):
        """one() n times, spans on and off in turn: {on: {part: [s]}}."""
        got = {True: {}, False: {}}
        for i in range(n):
            on = (i % 2 == 0) == first_on
            with _spans(on):
                for part, x in one(i).items():
                    got[on].setdefault(part, []).append(x)
        return got

    def live_calls(first_on):
        def one(i):
            t0 = time.perf_counter()
            vo.set_source_frame(I8[i], depth_m[i])
            vo.set_target_frame(I8[i + 1], depth_m[i + 1])
            vo.set_initial_state_vector(zero)
            res = vo.optimize()
            t1 = time.perf_counter()
            res.state.cpu()
            return {"host": t1 - t0, "full": time.perf_counter() - t0}

        return alternate(pairs, first_on, one)

    def chunk_calls(cell, first_on):
        prog = progs[cell]
        fn, scale = prog.chunk_entry(), prog.depth_scale
        carry = (drivers.to_device(I8[0], device),
                 drivers.to_device(D16[0], device).to(torch.float32) * float(np.float32(scale)))
        Ii, Dd = drivers.to_device(I8[1:chunk + 1], device), drivers.to_device(D16[1:chunk + 1], device)

        def one(i):
            sync()
            t0 = time.perf_counter()
            fn(*carry, Ii, Dd, scale)
            t1 = time.perf_counter()
            sync()
            return {"host": t1 - t0, "full": time.perf_counter() - t0}

        return alternate(chunks, first_on, one)

    def fleet_calls(first_on):
        """A fleet's round: one new frame a camera, float32 carries (as in
        every round after the first), the frames already on the card."""
        prog = progs["analytic5.fleet"]
        fn, scale = prog.chunk_entry(), prog.depth_scale
        idx = np.arange(cameras) % (len(I8) - 1)
        new = [drivers.to_device(a[idx + 1][:, None], device) for a in (I8, D16)]
        _, _, *carry = fn(drivers.to_device(I8[idx], device),
                          drivers.to_device(D16[idx], device).to(torch.float32) * float(np.float32(scale)),
                          *new, scale)

        def one(i):
            sync()
            t0 = time.perf_counter()
            fn(*carry, *new, scale)
            t1 = time.perf_counter()
            sync()
            return {"host": t1 - t0, "full": time.perf_counter() - t0}

        return alternate(chunks, first_on, one)

    calls = {"live_pair": live_calls,
             "analytic_chunk": lambda first_on: chunk_calls("analytic5.replay", first_on),
             "ceres_chunk": lambda first_on: chunk_calls("ceres5.replay", first_on),
             "fleet_round": fleet_calls}
    for fn in calls.values():  # warm-up: every shape, the kernels, the profiler's start
        with _profiler(True, device):
            fn(True)
    times = {}
    # spans on and off call by call, so that a drift of the host's speed
    # falls on both; each profiler window holds both
    for r in range(rounds):
        for prof in (False, True):
            for what, fn in calls.items():
                with _profiler(prof, device):
                    got = fn(r % 2 == 0)
                for on, parts in got.items():
                    key = f"{what} profiler={'on' if prof else 'off'} spans={'on' if on else 'off'}"
                    for part, xs in parts.items():
                        times.setdefault(key, {}).setdefault(part, []).extend(xs)
    out = {key: {f"{part}_ms_median": 1e3 * statistics.median(xs) for part, xs in parts.items()}
           for key, parts in times.items()}
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        with profiling.span("phovo.prep"):
            pass
    t1 = time.perf_counter()
    for _ in range(n):
        with profiling._NO_SPAN:
            pass
    t2 = time.perf_counter()
    out["span_off_ns"] = 1e9 * (t1 - t0) / n
    out["bare_null_context_ns"] = 1e9 * (t2 - t1) / n
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="mode", required=True)
    t = sub.add_parser("trace")
    t.add_argument("--workload", required=True)
    t.add_argument("--seeds", type=int, nargs="+", required=True)
    t.add_argument("--seconds", type=float, default=20.0)
    c = sub.add_parser("cost")
    c.add_argument("--pairs", type=int, default=40)
    c.add_argument("--chunks", type=int, default=4)
    c.add_argument("--rounds", type=int, default=3)
    for q in (t, c):
        q.add_argument("--device", default="cuda")
        q.add_argument("--out", type=Path, help="also append the JSON lines to this file")
    args = p.parse_args(argv)
    device = _device(args.device)
    print(f"card: {run.card_line() if device.type == 'cuda' else 'cpu'}", file=sys.stderr)
    if args.mode == "trace":
        lines = trace_runs(args.workload, args.seeds, args.seconds, device)
    else:
        lines = [cost(device, args.pairs, args.chunks, args.rounds)]
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with args.out.open("a") as f:
            for line in lines:
                f.write(json.dumps(dict(line, card=run.card_line() if device.type == "cuda" else "cpu")) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
