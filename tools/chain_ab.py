#!/usr/bin/env python3
"""A/B timing of phovo_tpu_torch's end-to-end chain calls from two source
trees on one NVIDIA GPU.

    python3 tools/chain_ab.py OTHER_TREE

OTHER_TREE is another checkout of the repository (an unpacked `git
archive` of another commit). Runs one measuring process per tree, in turns
(other, this, this, other), each importing phovo_tpu_torch from its own
tree and building its own kernels; each times, by CUDA events over
repeated calls after a warm-up, chip_smoke.py's phase-7 workloads on
device-resident frames (`make_pair(TUM_FR1, (480, 640))` alternated into
257 frames):
  * `align_sequence`, bench.py's schedule, fixed-75 and early exit at 300;
  * `align_sequence_autodiff`, config_5_level_optimization_ceres;
  * `align_analytic`, one VGA pair, config_5_level_optimization_analytic;
  * `align_sequence_ic`, bench.py's schedule, fixed-75 and early exit at
    300, and `align_ic`, one VGA pair, early exit at 300.
Prints every time with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPEATS = 10


def measure(tree: Path) -> dict:
    """The workloads' ms, timed with tree's phovo_tpu_torch and
    chip_smoke.py."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import chip_smoke
    from phovo_tpu_torch.models import analytic, autodiff, ic
    from phovo_tpu_torch.ops import _build
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.utils.config import config_from_dict
    from phovo_tpu_torch.utils.synthetic import make_pair

    _build.library()
    dev = torch.device("cuda", 0)
    I0, D0, I1, D1, _ = make_pair(TUM_FR1, (480, 640))
    Is = torch.from_numpy(np.stack([I0, I1] * 129)[:257]).to(dev)
    Ds = torch.from_numpy(np.stack([D0, D1] * 129)[:257]).to(dev)
    cfg_tr = config_from_dict(chip_smoke.CERES_PRESET)
    cfg_an = config_from_dict(chip_smoke.ANALYTIC_PRESET)
    zero6 = torch.zeros(6, device=dev)
    return {
        "align_sequence fixed-75": chip_smoke.cuda_ms(
            lambda: analytic.align_sequence(Is, Ds, TUM_FR1, chip_smoke.bench_config(0.0)), REPEATS),
        "align_sequence early exit": chip_smoke.cuda_ms(
            lambda: analytic.align_sequence(Is, Ds, TUM_FR1, chip_smoke.bench_config(300.0)), REPEATS),
        "align_sequence_autodiff ceres": chip_smoke.cuda_ms(
            lambda: autodiff.align_sequence_autodiff(Is, Ds, TUM_FR1, cfg_tr), 3),
        "align_analytic a VGA pair": chip_smoke.cuda_ms(
            lambda: analytic.align_analytic(Is[0], Ds[0], Is[1], Ds[1], TUM_FR1, zero6, cfg_an), REPEATS),
        "align_sequence_ic fixed-75": chip_smoke.cuda_ms(
            lambda: ic.align_sequence_ic(Is, Ds, TUM_FR1, chip_smoke.bench_config(0.0)), REPEATS),
        "align_sequence_ic early exit": chip_smoke.cuda_ms(
            lambda: ic.align_sequence_ic(Is, Ds, TUM_FR1, chip_smoke.bench_config(300.0)), REPEATS),
        "align_ic a VGA pair": chip_smoke.cuda_ms(
            lambda: ic.align_ic(Is[0], Ds[0], Is[1], Ds[1], TUM_FR1, zero6, chip_smoke.bench_config(300.0)),
            REPEATS),
    }


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(Path(sys.argv[2]))))
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 1
    other = Path(sys.argv[1]).resolve()
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    runs = {"other": [], "this": []}
    for key in ("other", "this", "this", "other"):
        tree = other if key == "other" else ROOT
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--measure", str(tree)], cwd=tree,
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"measuring {tree} failed:\n{proc.stderr[-4000:]}")
        runs[key].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for name in runs["this"][0]:
        o = [r[name] for r in runs["other"]]
        t = [r[name] for r in runs["this"]]
        print(f"{name}: other tree {o[0]:.3f}, {o[1]:.3f} ms; this tree {t[0]:.3f}, {t[1]:.3f} ms [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
