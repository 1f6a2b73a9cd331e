"""The benchmark of phovo_tpu_torch: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card. The cell
is an entry of `workloads` in BENCHMARK.json; its configuration file, its
traffic mix (benchmark/traffic/<traffic>.json), its limits
(benchmark/limits/<cell>.json) and each metric's reader
(benchmark/metrics/<metric>.py) are found by name. The run renders the
sequence on the card from the seed, warms up, measures for --seconds,
checks every answer of the window against the plain reference, and prints
one JSON line last on standard output: with --trace 0 the cell's
end-to-end metrics, with --trace 1 its per-layer metrics from a profiler
trace of part of the window. A driver that runs on to the end of a pass
reports the window's true length, which the rates divide by. The line
carries the host's state and the card's SM clock at the driver's start
and the window's end under "host", which no metric reads.
"""

import time

T_PROCESS = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = ROOT / "benchmark"
# the checkout's root, not this file's folder, is where imports start
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != BENCH_DIR]
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "phovo_tpu")
SPANS = ("copy", "align call", "pose integrate", "frame wait", "set frames", "optimize")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_files(bench: dict, cell_name: str, root: Path = ROOT) -> tuple[dict, dict, dict, dict]:
    """(the cell's entry, its configuration, its traffic mix, its limits),
    each found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json (there are {sorted(cells)})")
    cell = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    mix = load_json(root / "benchmark" / "traffic" / f"{cell['traffic']}.json")
    limits_path = root / "benchmark" / "limits" / f"{cell_name}.json"
    limits = load_json(limits_path) if limits_path.is_file() else {}
    return cell, config, mix, limits


def cell_metrics(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metric entries a run of the cell reports: the end-to-end ones
    (--trace 0) or the per-layer ones (--trace 1) that name the cell, or
    that name no cells and move an end-to-end metric the cell reports."""
    def names(entry):
        return entry.get("workloads")

    e2e = [m for m in bench["end_to_end"] if names(m) is None or cell_name in names(m)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (m["moves"] in moved if names(m) is None else cell_name in names(m))]


def load_reader(name: str, root: Path = ROOT):
    """The read(record) function of benchmark/metrics/<name>.py."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def apply_overrides(config: dict, mix: dict, overrides: dict | None) -> None:
    """Sizes a test sets instead of the files': "shape" (H, W) with the
    intrinsics scaled to it, "frames", "chunk"."""
    if not overrides:
        return
    cam = config["camera"]
    if "shape" in overrides:
        H, W = overrides["shape"]
        f = W / cam["width"]
        for k in ("fx", "fy", "cx", "cy"):
            cam[k] = cam[k] * f
        cam["height"], cam["width"] = H, W
    if "frames" in overrides:
        mix["scene"]["frames"] = overrides["frames"]
    if "chunk" in overrides:
        mix["chunk"] = overrides["chunk"]


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device, t_process: float,
             bench: dict | None = None, overrides: dict | None = None, root: Path = ROOT,
             keep: bool = False) -> dict:
    """One run of a cell on `device`, everything after the look for a card:
    the record the metric readers read, with the check's numbers; keep
    adds what the check compared (the calibration reads it)."""
    import numpy as np
    import torch

    from benchmark import check, drivers, host, program_spans, work
    from benchmark.tracing import Tracer, reduce
    from benchmark.traffic.generator import make_sequence

    seed = int(seed) % 2**63  # any whole number; the generators take 63 bits
    bench = bench or load_json(root / "BENCHMARK.json")
    cell, config, mix, limits = cell_files(bench, cell_name, root)
    apply_overrides(config, mix, overrides)
    cuda = device.type == "cuda"
    t_program = time.perf_counter()
    prog = drivers.Program(config, device)
    if cuda:  # the CPU runs the program's plain twins, which need no kernels
        prog.load_kernels()
    t_frames = time.perf_counter()
    seq = make_sequence(mix["scene"], config["camera"], seed, device)
    t_warm = time.perf_counter()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    tracer = Tracer(mix["trace_lead_s"], mix["trace_seconds"], device) if trace else None
    t_read = time.perf_counter()
    host_start = host.state(device)
    read_s = time.perf_counter() - t_read  # the reading is the line's, not set-up's
    # set-up's objects leave the collector's generations: a collection in
    # the window then walks the window's objects only
    gc.collect()
    gc.freeze()
    out = drivers.find(mix["driver"])(prog, seq, mix, seconds, tracer, np.random.default_rng(seed))
    gc.unfreeze()
    if tracer is not None:
        tracer.stop()
    if cuda:
        torch.cuda.synchronize(device)
    record = {
        "cell": cell_name, "seconds": out.get("window_s", seconds), "setup_s": out["t_start"] - t_process - read_s,
        # set-up's parts: process start, imports and the card; the program
        # and its kernels (nvcc in a checkout's first run); the frames; the
        # warm-up of the window's shapes (and the profiler's, traced)
        "setup_parts": {"start_s": t_program - t_process, "program_s": t_frames - t_program,
                        "frames_s": t_warm - t_frames, "warm_s": out["t_start"] - t_warm - read_s},
        "frames_done": out["frames_done"], "latencies": out["latencies"],
        "attempted": out["attempted"], "missing": out["missing"],
        "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0,
        "host": {"start": host_start, "end": host.state(device)},
    }
    if tracer is not None and tracer.events is not None:
        traced = [c for c in out["calls"] if tracer.in_trace(c["t"])]
        its = [c["iterations"].detach().cpu().numpy().reshape(-1, c["iterations"].shape[-1]) for c in traced]
        shape = (config["camera"]["height"], config["camera"]["width"])
        record["trace"] = reduce(tracer.events, SPANS)
        record["trace"]["program"] = program_spans.attribute(tracer.events)
        record["trace"].update(
            frames=sum(c["frames"] for c in traced),
            # each level kernel: its name in the trace and the (bytes,
            # operations) of each launch the traced calls made
            kernels={model: {"name": name, "launches": [
                lw for it in its for lw in work.call_work(model, it, shape, prog.sampling,
                                                          config["preset"]["max_iterations"])]}
                     for model, name in prog.level_kernels.items()},
        )
        tracer.events = None
    chains = [c.finish() for c in out["chains"]]
    del out, prog
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    uniq = check.distinct_pairs(chains)
    ref = check.reference_answers(uniq, seq, config, device)
    record["numbers"] = check.compare(chains, ref, uniq, config, record["missing"])
    record["numbers"].update(check.backend_numbers(chains, ref, uniq, seq, config, device))
    record["numbers"]["check_s"] = time.perf_counter() - t_check
    record["correct"], record["checks"] = check.judge(record["numbers"], limits)
    if keep:
        record.update(chains=chains, uniq=uniq, ref=ref, seq=seq, config=config)
    return record


def result_line(bench: dict, cell_name: str, record: dict, trace: bool, device_info: dict,
                root: Path = ROOT) -> dict:
    metrics = {}
    for m in cell_metrics(bench, cell_name, trace):
        value = load_reader(m["name"], root)(record)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {
        "correct": bool(record["correct"]),
        "attempted": int(record["attempted"]),
        "failed": int(record["missing"]),
        "metrics": metrics,
        "device": device_info,
    }
    if trace and record.get("trace"):
        device_info["busy_s"] = record["trace"]["busy_s"]
        device_info["window_s"] = record["trace"]["window_s"]
        line["breakdown"] = record["trace"]["breakdown"]
    line["setup_parts"] = record["setup_parts"]
    line["host"] = record["host"]
    line["checks"] = record["checks"]
    return line


def forbidden_modules() -> list[str]:
    """The forbidden top-level names (whole) that sys.modules holds."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def report(bench: dict, cell_name: str, record: dict, trace: bool, device_info: dict,
           root: Path = ROOT) -> int:
    """Builds the run's line (every metric reader has run), then looks at
    sys.modules and prints the line only where nothing forbidden was
    loaded: 0, or 3 with no result. The check's numbers end standard
    error either way."""
    line = result_line(bench, cell_name, record, trace, device_info, root)
    print("look: " + json.dumps(record["numbers"]), file=sys.stderr)
    print("setup: " + json.dumps(record["setup_parts"]), file=sys.stderr)
    loaded = forbidden_modules()
    if loaded:
        print(f"error: the run loaded {loaded}, which the benchmark must not", file=sys.stderr)
    for name, c in record["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    if not record["checks"]:
        print(f"check: no limits for {cell_name}", file=sys.stderr)
    sys.stderr.flush()
    if loaded:
        return 3
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    cell, _, _, _ = cell_files(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: {args.workload} needs {cell['chips']} CUDA card(s); torch finds {found}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"card: {card_line()}", file=sys.stderr)
    record = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device, T_PROCESS, bench)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(record["memory_peak_bytes"])}
    return report(bench, args.workload, record, bool(args.trace), info)

if __name__ == "__main__":
    sys.exit(main())
