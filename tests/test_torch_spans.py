"""The port's own spans (utils/profiling.span) on the CPU: nothing is made
while no profiler runs; inside profiling.trace the chunked entries, the
serving round and the object API write phovo.align, phovo.prep,
phovo.level (and phovo.upload, object API) as user annotations, each level
inside its call, one a active level."""

import json

import numpy as np
import pytest
import torch

from phovo_tpu_torch.models.analytic import align_sequence_chunk
from phovo_tpu_torch.models.autodiff import PhotoconsistencyOdometryAutodiff, align_sequence_chunk_autodiff
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.parallel.batch import serve_sequences_chunk
from phovo_tpu_torch.utils import profiling
from phovo_tpu_torch.utils.config import load_builtin
from phovo_tpu_torch.utils.synthetic import make_pair

INTR = Intrinsics(80.0, 80.0, 39.5, 29.5)
K = np.array([[80.0, 0.0, 39.5], [0.0, 80.0, 29.5], [0.0, 0.0, 1.0]])
ANALYTIC = load_builtin("config_5_level_optimization_analytic")  # levels 2-4 active
CERES = load_builtin("config_5_level_optimization_ceres")  # all five
COUNTS_PER_M = 5000.0


@pytest.fixture(scope="module")
def frames():
    """Three 60x80 frames in storage dtype (uint8 intensity, uint16 depth
    counts) and the first pair as the object API takes it."""
    I0, D0, I1, D1, _ = make_pair(INTR, (60, 80), np.array([0.01, -0.02, 0.06, 0.01, -0.02, 0.015], np.float32))
    i8 = (np.stack([I0, I1, I0]) * 255).astype(np.uint8)
    d16 = (np.stack([D0, D1, D0]) * COUNTS_PER_M).astype(np.uint16)
    return torch.from_numpy(i8), torch.from_numpy(d16), (i8[0], D0, i8[1], D1)


def _chunk(entry, config):
    def call(frames):
        i8, d16, _ = frames
        carry_d = d16[0].to(torch.float32) / COUNTS_PER_M
        entry(i8[0], carry_d, i8[1:], d16[1:], INTR, config, depth_scale=1.0 / COUNTS_PER_M)

    return call


def _object_api(frames):
    si, sd, ti, td = frames[2]
    vo = PhotoconsistencyOdometryAutodiff(CERES, device="cpu")
    vo.set_intrinsic_matrix(K)
    vo.set_source_frame(si, sd)
    vo.set_target_frame(ti, td)
    vo.optimize()


PATHS = {
    "chunk_analytic": (_chunk(align_sequence_chunk, ANALYTIC), ANALYTIC, False),
    "chunk_autodiff": (_chunk(align_sequence_chunk_autodiff, CERES), CERES, False),
    "object_api_ceres": (_object_api, CERES, True),
}


def test_no_profiler_no_span(frames, monkeypatch):
    """Without a profiler span() hands out one shared null context, and a
    chunk makes no annotation."""
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("phovo.prep") is profiling.span("phovo.level")
    made = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: made.append(name))
    PATHS["chunk_analytic"][0](frames)
    assert made == []


@pytest.mark.parametrize("path", sorted(PATHS))
def test_a_traced_call_writes_its_spans(frames, tmp_path, path):
    run, config, uploads = PATHS[path]
    with profiling.trace(tmp_path) as window:
        run(frames)
    events = json.loads(window.path.read_text())["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("cat") == "user_annotation" and e["name"].startswith("phovo.")]
    names = {n for n, _, _ in spans}
    assert names == {"phovo.align", "phovo.prep", "phovo.level"} | ({"phovo.upload"} if uploads else set())
    aligns = [(a, b) for n, a, b in spans if n == "phovo.align"]
    levels = [(a, b) for n, a, b in spans if n == "phovo.level"]
    assert len(aligns) == 1
    assert len(levels) == sum(m > 0 for m in config.max_iterations)
    assert all(aligns[0][0] <= a and b <= aligns[0][1] for a, b in levels)
    # the frames go up before the call, outside it
    assert all(b <= aligns[0][0] for n, _, b in spans if n == "phovo.upload")


def test_a_served_round_nests_its_spans_in_one_align(frames, tmp_path):
    """One round of serve_sequences_chunk, two streams and one new frame
    each: the round is one outermost phovo.align (align_sequences and
    align_sequences_levelmajor open theirs inside it); every phovo.prep
    (each stream's conversion, the packs) and phovo.level (one a active
    level, both streams' pairs in it) lies inside it."""
    i8, d16, _ = frames
    carry_d = d16[:2].to(torch.float32) / COUNTS_PER_M
    with profiling.trace(tmp_path) as window:
        serve_sequences_chunk(i8[:2], carry_d, i8[1:, None], d16[1:, None], INTR, ANALYTIC,
                              depth_scale=1.0 / COUNTS_PER_M)
    events = json.loads(window.path.read_text())["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("cat") == "user_annotation" and e["name"].startswith("phovo.")]
    aligns = [(a, b) for n, a, b in spans if n == "phovo.align"]
    outer = [(a, b) for a, b in aligns if not any(c < a and b < d for c, d in aligns)]
    assert len(outer) == 1 and len(aligns) == 3
    lo, hi = outer[0]
    assert {n for n, _, _ in spans} == {"phovo.align", "phovo.prep", "phovo.level"}
    assert all(lo <= a and b <= hi for _, a, b in spans)
    assert sum(n == "phovo.prep" for n, _, _ in spans) >= 3  # two streams' conversions, the packs
    assert sum(n == "phovo.level" for n, _, _ in spans) == sum(m > 0 for m in ANALYTIC.max_iterations)
