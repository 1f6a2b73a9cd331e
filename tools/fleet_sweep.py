#!/usr/bin/env python3
"""How many cameras one card serves at 30 Hz: the analytic5.fleet cell
(benchmark/drivers/fleet.py, one new frame a camera a round through
parallel/batch.serve_sequences_chunk) run at 8, 16, 24, ... cameras.

    python3 tools/fleet_sweep.py [--start 8] [--step 8] [--stop 512] [--seconds 20]
                                 [--traced-seconds 6] [--limit-ms 33.3] [--seed N] [--out FILE]

Each count is one untraced run of --seconds (the round's latency p50 and
p95 over every camera frame, `correct`, the memory peak) and one traced
run of --traced-seconds (the cell's per-layer metrics: device idle,
launches and copy and prep ms a camera frame, K-GN's roofline share), both
as benchmark/run.py makes them, with the mix's camera count replaced. The
sweep stops after the first count whose p95 passes --limit-ms (one frame
period at 30 Hz), prints one JSON line a count, and last the largest
count that stayed under the limit and half of it rounded down to a
multiple of --step: the cell's count. --device cpu runs at 60x80 for a
rehearsal.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402

CELL = "analytic5.fleet"
SMALL = {"shape": (60, 80), "frames": 12}


def one_count(cameras: int, seed: int, seconds: float, traced_seconds: float, device, bench: dict) -> dict:
    import torch

    real = run.cell_files

    def with_cameras(*a, **k):
        cell, config, mix, limits = real(*a, **k)
        mix["cameras"] = cameras
        return cell, config, mix, limits

    overrides = SMALL if device.type == "cpu" else None
    info = {"platform": device.type}
    line = {"cameras": cameras, "seed": seed}
    run.cell_files = with_cameras
    try:
        for trace, secs in ((False, seconds), (True, traced_seconds)):
            rec = run.run_cell(CELL, seed, secs, trace, device, time.perf_counter(), bench, overrides)
            got = run.result_line(bench, CELL, rec, trace, dict(info))
            line.update({k: v["value"] for k, v in got["metrics"].items()})
            if not trace:
                lat = sorted(rec["latencies"])
                line.update(latency_p50_ms=1e3 * statistics.median(lat), rounds=len(lat) // cameras,
                            late_rounds=sum(x > 1.0 / 30 for x in lat[::cameras]),
                            correct=got["correct"], failed=got["failed"], attempted=got["attempted"],
                            memory_peak_bytes=int(rec["memory_peak_bytes"]), checks=got["checks"])
            else:
                line["traced_correct"] = got["correct"]
                line["busy_share"] = got["device"].get("busy_s", 0.0) / max(got["device"].get("window_s", 1.0), 1e-9)
            del rec
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        run.cell_files = real
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--start", type=int, default=8)
    p.add_argument("--step", type=int, default=8)
    p.add_argument("--stop", type=int, default=512)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--traced-seconds", type=float, default=6.0)
    p.add_argument("--limit-ms", type=float, default=1e3 / 30)
    p.add_argument("--seed", type=int, default=2**31 + 77)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", type=Path, help="also append the JSON lines to this file")
    args = p.parse_args(argv)
    import torch

    device = torch.device(args.device if args.device != "cuda" else "cuda:0")
    card = "cpu"
    if device.type == "cuda":
        torch.cuda.set_device(device)
        card = run.card_line()
    print(f"card: {card}", file=sys.stderr)
    bench = run.load_json(ROOT / "BENCHMARK.json")
    lines, best = [], 0
    for cameras in range(args.start, args.stop + 1, args.step):
        line = dict(one_count(cameras, args.seed + cameras, args.seconds, args.traced_seconds, device, bench),
                    card=card)
        lines.append(line)
        print(json.dumps(line), flush=True)
        if line["latency_p95_ms"] > args.limit_ms:
            break
        best = cameras
    last = {"largest_under_limit": best, "cell_cameras": (best // 2) // args.step * args.step,
            "limit_ms": args.limit_ms, "seconds": args.seconds, "card": card}
    lines.append(last)
    print(json.dumps(last), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with args.out.open("a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
