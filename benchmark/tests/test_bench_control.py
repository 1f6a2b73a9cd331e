"""`correct` comes out false for the control and for each fault a cell can
have, at 60x80 on the CPU with the cells' own limits.

The control is the reference computed with its per-frame packs rounded to
bfloat16, put in the program's place (benchmark/calibrate.py). The faults
are planted under a run that skips the look for a card: a step that
returns its state unchanged, half of a call's pairs left out (the mean of
the rest in their place), and one answer altered where it is produced. A
fault of the exchange between chips has no place here: every cell runs on
one chip."""

import numpy as np
import pytest
import torch

from benchmark import calibrate, check, drivers
from benchmark.tests.helpers import small_run

CELLS = ["analytic5.replay", "ceres5.replay", "ceres5.live"]


@pytest.mark.parametrize("seed", [101, 2**35 + 5, 77777])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, seed):
    rec = small_run(cell, seed=seed, keep=True)
    assert rec["correct"], rec["checks"]
    ctl = check.reference_answers(rec["uniq"], rec["seq"], rec["config"], torch.device("cpu"), torch.bfloat16)
    numbers = check.compare(calibrate.control_chains(rec["chains"], rec["uniq"], ctl), rec["ref"], rec["uniq"],
                            rec["config"], 0)
    limits = {k: v["limit"] for k, v in rec["checks"].items()}
    ok, _ = check.judge(numbers, limits)
    assert not ok, numbers


def _unchanged(res):
    return res._replace(state=torch.zeros_like(res.state))


def _half_left_out(res):
    """The first half of the pairs aligned, the mean of their states given
    for the rest."""
    state = res.state.clone()
    flat = state.reshape(-1, 6)
    half = max(1, flat.shape[0] // 2)
    flat[half:] = flat[:half].mean(0)
    if flat.shape[0] == 1:
        flat[:] = 0.0
    return res._replace(state=state)


def _altered(res):
    state = res.state.clone()
    state.reshape(-1, 6)[-1, 0] += 0.05
    return res._replace(state=state)


FAULTS = {"unchanged": _unchanged, "half_left_out": _half_left_out, "altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    plant = FAULTS[fault]
    chunk_entry, object_api = drivers.Program.chunk_entry, drivers.Program.object_api

    def broken_chunk_entry(self):
        fn = chunk_entry(self)

        def call(*a, **k):
            res, ci, cd = fn(*a, **k)
            return plant(res), ci, cd

        return call

    def broken_object_api(self):
        vo = object_api(self)
        optimize = vo.optimize
        vo.optimize = lambda: plant(optimize())
        return vo

    monkeypatch.setattr(drivers.Program, "chunk_entry", broken_chunk_entry)
    monkeypatch.setattr(drivers.Program, "object_api", broken_object_api)
    rec = small_run(cell, seed=404)
    assert rec["correct"] is False, rec["checks"]
    assert np.isfinite(rec["numbers"]["state_gap"])
