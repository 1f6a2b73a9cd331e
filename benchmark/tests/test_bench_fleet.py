"""The fleet cell (analytic5.fleet: benchmark/drivers/fleet.py through
parallel/batch.serve_sequences_chunk, one new frame a camera a round): its
driver at 60x80 on the CPU with a few cameras, its limits against the
control and planted faults, the program's spans along its path, and on the
card the round's one K-PREP launch."""

import json

import numpy as np
import pytest
import torch

from benchmark import calibrate, check, drivers, program_spans, run, tracing
from benchmark.tests.helpers import small_run
from benchmark.tests.test_bench_control import FAULTS
from benchmark.tests.test_bench_layout import _copy_checkout

CELL = "analytic5.fleet"
CAMERAS = 3


def _fleet_checkout(tmp_path, cameras=CAMERAS):
    """A copy of the benchmark whose fleet mix has `cameras` cameras."""
    root, bench = _copy_checkout(tmp_path)
    path = root / "benchmark" / "traffic" / "fleet.json"
    mix = json.loads(path.read_text())
    mix["cameras"] = cameras
    path.write_text(json.dumps(mix))
    return root, bench


def test_the_fleet_is_one_chain_a_camera_and_a_latency_a_camera_frame(tmp_path):
    root, bench = _fleet_checkout(tmp_path)
    rec = small_run(CELL, seed=2**34 + 9, root=root, bench=bench, keep=True)
    line = run.result_line(bench, CELL, rec, False, {"platform": "cpu"}, root=root)
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    assert {"latency_p95_ms", "setup_s"} <= set(line["metrics"])
    lat = rec["latencies"]
    assert len(lat) == rec["attempted"] == rec["frames_done"] > 0 and len(lat) % CAMERAS == 0
    # every camera of a round waits for the round's last pose
    rounds = np.asarray(lat).reshape(-1, CAMERAS)
    assert (rounds == rounds[:, :1]).all()
    assert len(rec["chains"]) == CAMERAS
    N = len(rec["seq"][0])
    for ch in rec["chains"]:
        assert len(ch["pairs"]) == len(rounds)
        assert ((ch["pairs"][:, 0] + 1) % N == ch["pairs"][:, 1]).all()
        assert (ch["pairs"][1:, 0] == ch["pairs"][:-1, 1]).all()


@pytest.mark.parametrize("seed", [101, 2**35 + 5, 77777])
def test_the_control_is_not_correct_on_the_fleet(seed):
    rec = small_run(CELL, seed=seed, keep=True)
    assert rec["correct"], rec["checks"]
    ctl = check.reference_answers(rec["uniq"], rec["seq"], rec["config"], torch.device("cpu"), torch.bfloat16)
    numbers = check.compare(calibrate.control_chains(rec["chains"], rec["uniq"], ctl), rec["ref"], rec["uniq"],
                            rec["config"], 0)
    ok, _ = check.judge(numbers, {k: v["limit"] for k, v in rec["checks"].items()})
    assert not ok, numbers


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct_on_the_fleet(fault, monkeypatch):
    plant = FAULTS[fault]
    chunk_entry = drivers.Program.chunk_entry

    def broken_chunk_entry(self):
        fn = chunk_entry(self)

        def call(*a, **k):
            res, poses, ci, cd = fn(*a, **k)
            return plant(res), poses, ci, cd

        return call

    monkeypatch.setattr(drivers.Program, "chunk_entry", broken_chunk_entry)
    rec = small_run(CELL, seed=404)
    assert rec["correct"] is False, rec["checks"]
    assert np.isfinite(rec["numbers"]["state_gap"])


def test_a_traced_fleet_run_carries_the_spans_of_its_path(monkeypatch):
    """The window's events of a traced 60x80 run hold the serving round's
    spans (phovo.align around each round, phovo.prep, phovo.level), with
    host time and no kernel (the CPU runs the plain twins)."""
    seen = []
    reduce = tracing.reduce

    def keep(events, spans):
        seen.append(program_spans.attribute(events))
        return reduce(events, spans)

    monkeypatch.setattr(tracing, "reduce", keep)
    rec = small_run(CELL, seed=2**35 + 3, seconds=3.0, trace=True)
    assert rec["trace"]["frames"] > 0 and len(seen) == 1
    got = seen[0]
    path = {"phovo.align", "phovo.prep", "phovo.level"}
    assert {name for name in got if name.startswith(program_spans.PREFIX)} == path
    for name in path:
        assert got[name]["spans"] > 0 and got[name]["host_s"] > 0
    assert all(row["launches"] == 0 for row in got.values())


@pytest.mark.cuda
def test_a_round_at_vga_takes_one_prep_launch(card):
    """One round of the fleet's entry at 640x480 on the card, four cameras,
    float32 carries as the rounds after the first hold them: one K-PREP
    launch for every carry and new frame, no torch-chain call, one K-GN
    launch a active level."""
    from phovo_tpu_torch.ops import fused_batch, prep

    from benchmark.traffic.generator import make_sequence

    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    _, config, mix, _ = run.cell_files(bench, CELL)
    run.apply_overrides(config, mix, {"frames": 12})
    prog = drivers.Program(config, card)
    prog.load_kernels()
    I8, D16 = make_sequence(mix["scene"], config["camera"], 2**33 + 1, card)
    fn = prog.chunk_entry()
    cams = [0, 2, 4, 6]
    carry = [drivers.to_device(I8[cams], card),
             drivers.to_device(D16[cams], card).to(torch.float32) * float(np.float32(prog.depth_scale))]
    for k in (1, 2):
        now = [c + k for c in cams]
        if k == 2:
            prep.PREP_LAUNCHES = prep.PREP_TORCH_CALLS = 0
            before = fused_batch.LAUNCHES
        Ii = drivers.to_device(np.stack([I8[f] for f in now])[:, None], card)
        Dd = drivers.to_device(np.stack([D16[f] for f in now])[:, None], card)
        res, _, *carry = fn(*carry, Ii, Dd, prog.depth_scale)
    torch.cuda.synchronize(card)
    assert carry[0].dtype == torch.float32
    assert (prep.PREP_LAUNCHES, prep.PREP_TORCH_CALLS) == (1, 0)
    assert fused_batch.LAUNCHES - before == sum(m > 0 for m in config["preset"]["max_iterations"])
    assert res.state.shape == (len(cams), 1, 6) and torch.isfinite(res.state).all()
