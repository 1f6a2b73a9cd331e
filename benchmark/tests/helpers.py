"""Small runs of the harness on the CPU for the benchmark's tests."""

import time

import torch

from benchmark import run

SMALL = {"shape": (60, 80), "frames": 12}
# per cell, what a 60x80 run of 12 frames changes besides the size
CELL_SMALL = {
    "analytic5.replay": {"chunk": 4},
    "ceres5.replay": {"chunk": 4},
    "ceres5.live": {},
}


def small_run(cell, seed=7, seconds=1.5, trace=False, keep=False, root=run.ROOT, bench=None, extra=None):
    torch.set_num_threads(2)
    overrides = dict(SMALL, **CELL_SMALL.get(cell, {}), **(extra or {}))
    return run.run_cell(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter(), bench=bench,
                        overrides=overrides, root=root, keep=keep)
