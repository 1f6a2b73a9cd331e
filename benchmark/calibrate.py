"""Readings that set a cell's limits (benchmark/limits/<cell>.json): the
check's numbers of the program and of the control on each seed.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--out FILE]

Each seed is one run of the cell as benchmark/run.py makes it (set-up,
window, the reference's answers), in one process. The control is the
reference computed with its per-frame packs rounded to bfloat16, put in
the program's place: its answers to the same pairs, integrated by the
harness as the program's are, judged by the same comparison. Prints one
JSON line a seed with both sets of numbers, and with --out appends them
to FILE.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from benchmark import check, run  # noqa: E402
from benchmark.drivers import integrate  # noqa: E402


def control_chains(chains, uniq, answers, seq=None, config=None, device=None):
    """The program's chains with the control's answers in place of the
    program's, integrated by the harness; a chain's keyframe poses are
    those the configuration's reference back end makes of the control's
    answers to its edges (seq, config and device given)."""
    states, its, valid = answers
    rows = check.key_rows(uniq)
    out = []
    for ch in chains:
        at = check.rows_of(rows, ch)
        poses, _ = integrate(np.eye(4), states[at])
        out.append({"pairs": ch["pairs"], "inits": ch.get("inits"), "states": states[at], "poses": poses,
                    "iterations": its[at], "num_valid": valid[at]})
        kf = ch.get("keyframes")
        if kf is not None and config is not None and config.get("reference_backend"):
            graph = {k: kf[k] for k in ("frames", "edges", "weights")}
            edge = at[kf["edges"][:, 2]]
            kf_poses = check.backend(config["reference_backend"]).solve(
                graph, tuple(a[edge] for a in answers), seq, config, device)
            out[-1]["keyframes"] = dict(graph, poses=np.asarray(kf_poses, np.float64))
    return out


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=None,
                   help="run the control on the first N seeds only (default: every seed)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    device = torch.device("cuda", 0)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        rec = run.run_cell(args.workload, seed, args.seconds, False, device, t0, keep=True)
        line = {"workload": args.workload, "seed": seed, "program": rec["numbers"]}
        if args.controls is None or i < args.controls:
            ctl = check.reference_answers(rec["uniq"], rec["seq"], rec["config"], device, torch.bfloat16)
            chains = control_chains(rec["chains"], rec["uniq"], ctl, rec["seq"], rec["config"], device)
            line["control"] = check.compare(chains, rec["ref"], rec["uniq"], rec["config"], 0)
            line["control"].update(check.backend_numbers(chains, rec["ref"], rec["uniq"], rec["seq"],
                                                         rec["config"], device))
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del rec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
