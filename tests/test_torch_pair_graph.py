"""The object API's pair graph (models/base.PairGraph) on the CPU: which
calls a backend says it can capture (the rule, asked with the device
passed in), that the CPU object API never reaches the graph and gives
align_autodiff's results as before, how optimize() routes and stages into
the graph's buffers, and the graph's bookkeeping (eager first call, flat
result, counters) with torch.cuda's graph replaced by a stand-in. The card
runs the real capture (tests/test_torch_graph_cuda.py)."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from phovo_tpu_torch.models import base
from phovo_tpu_torch.models.analytic import PhotoconsistencyOdometryAnalytic
from phovo_tpu_torch.models.autodiff import PhotoconsistencyOdometryAutodiff, align_autodiff
from phovo_tpu_torch.ops import fused_batch, prep
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.utils.config import load_builtin
from phovo_tpu_torch.utils.synthetic import make_pair

CERES5 = load_builtin("config_5_level_optimization_ceres")  # unblurred, five active levels
BLURRED = load_builtin("config_3_level_optimization_ceres")  # blurs level 2
VGA = (480, 640)
U8, F32 = torch.uint8, torch.float32
INTR = Intrinsics(80.0, 80.0, 39.5, 29.5)
K = np.array([[80.0, 0.0, 39.5], [0.0, 80.0, 29.5], [0.0, 0.0, 1.0]])
FAST = dataclasses.replace(CERES5, max_iterations=(2, 2, 3, 3, 3))


@pytest.mark.parametrize("backend,config,mode,device,shape,dtypes,want", [
    ("ceres", CERES5, "linearizer", "cuda", VGA, (U8, F32, U8), True),
    ("ceres", CERES5, "linearizer", "cuda:0", VGA, (F32, F32, F32), True),
    ("ceres", CERES5, "linearizer", "cuda", VGA, (U8, F32, F32), True),
    ("ceres", CERES5, "linearizer", "cuda", (240, 320), (U8, F32, U8), True),
    ("ceres", CERES5, "linearizer", "cpu", VGA, (U8, F32, U8), False),
    ("ceres", CERES5, "jacfwd", "cuda", VGA, (U8, F32, U8), False),
    ("ceres", BLURRED, "linearizer", "cuda", VGA, (U8, F32, U8), False),
    ("ceres", dataclasses.replace(CERES5, robust_loss="tdist"), "linearizer", "cuda", VGA, (U8, F32, U8), False),
    ("ceres", CERES5, "linearizer", "cuda", (481, 640), (U8, F32, U8), False),
    ("ceres", CERES5, "linearizer", "cuda", VGA, (torch.float64, F32, U8), False),
    ("ceres", CERES5, "linearizer", "cuda", VGA, (U8, torch.uint16, U8), False),
    ("analytic", load_builtin("config_5_level_optimization_analytic"), None, "cuda", VGA, (U8, F32, U8), False),
])
def test_capturable_rule(backend, config, mode, device, shape, dtypes, want):
    """The card, the linearizer Jacobian, a loss other than tdist and
    frames K-PREP takes (uint8 or float32 intensities, float32 depth, no
    blur, exact 2^k levels): only then does the ceres object API capture.
    The analytic object API never does."""
    if backend == "ceres":
        vo = PhotoconsistencyOdometryAutodiff(config, mode, device="cpu")
    else:
        vo = PhotoconsistencyOdometryAnalytic(config, device="cpu")
    assert vo.capturable(torch.device(device), shape, *dtypes) is want


@pytest.fixture(scope="module")
def pairs():
    """Two 60x80 pairs as the object API takes them: uint8 intensity and
    float32 metres, the second pair's source the first's target."""
    I0, D0, I1, D1, _ = make_pair(INTR, (60, 80), np.array([0.01, -0.02, 0.06, 0.01, -0.02, 0.015], np.float32))
    i8 = [(I * 255).astype(np.uint8) for I in (I0, I1, I0)]
    d = [np.asarray(x, np.float32) for x in (D0, D1, D0)]
    inits = [np.zeros(6, np.float32), np.array([0.002, -0.001, 0.003, 0.001, 0.0, -0.002], np.float32)]
    return [(i8[k], d[k], i8[k + 1], d[k + 1], inits[k]) for k in range(2)]


def _eager(pair, config):
    si, sd, ti, td, init = (torch.from_numpy(np.asarray(x)) for x in pair)
    return align_autodiff(si, sd, ti, td, INTR, init, config)


def _run(vo, pair):
    si, sd, ti, td, init = pair
    vo.set_source_frame(si, sd)
    vo.set_target_frame(ti, td)
    vo.set_initial_state_vector(init)
    return vo.optimize()


def _assert_equal(got, want):
    for name, g, w in zip(base.AlignmentResult._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w), name


@pytest.mark.parametrize("config,mode", [(CERES5, "linearizer"), (BLURRED, "linearizer"), (FAST, "jacfwd")])
def test_cpu_object_api_never_touches_the_graph(pairs, monkeypatch, config, mode):
    """On the CPU no call is capturable: optimize() runs align_autodiff as
    before, bit for bit, and never builds a PairGraph."""

    def refuse():
        raise AssertionError("the CPU object API built a PairGraph")

    monkeypatch.setattr(base, "PairGraph", refuse)
    counts = (base.GRAPH_CAPTURES, base.GRAPH_REPLAYS)
    vo = PhotoconsistencyOdometryAutodiff(config, mode, device="cpu")
    vo.set_intrinsic_matrix(K)
    for pair in pairs:
        got = _run(vo, pair)
        si, sd, ti, td, init = (torch.from_numpy(np.asarray(x)) for x in pair)
        _assert_equal(got, align_autodiff(si, sd, ti, td, INTR, init, config, mode))
    assert vo._graph is None and (base.GRAPH_CAPTURES, base.GRAPH_REPLAYS) == counts


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph on the CPU: the block in
    torch.cuda.graph runs (its ops compute there, on the captured pair),
    and a replay does nothing, so the flat result keeps what the capture
    computed. `seen` holds, for each capture and replay, the card that was
    current then (and the capture stream's card)."""

    replays = 0
    seen = []

    def replay(self):
        _FakeGraph.replays += 1
        _FakeGraph.seen.append(("replay", _FakeCard.current))


class _FakeCard:
    """Stands in for torch.cuda.device: its device is the current card
    while it is entered (None outside every one)."""

    current = None

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        self.before, _FakeCard.current = _FakeCard.current, self.device

    def __exit__(self, *exc):
        _FakeCard.current = self.before


class _FakeStream:
    """Stands in for torch.cuda.Stream: a stream of the current card."""

    def __init__(self):
        self.device = _FakeCard.current


@contextlib.contextmanager
def _fake_capture(graph, stream, **kw):
    _FakeGraph.seen.append(("capture", _FakeCard.current, stream.device))
    yield


@pytest.fixture
def fake_cuda_graph(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    monkeypatch.setattr(torch.cuda, "device", _FakeCard)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    _FakeGraph.replays = 0
    _FakeGraph.seen = []


def _counting_align(result):
    """An align that returns `result` and counts one K-PREP and five K-TR
    launches a call, as the ceres pair does on the card."""
    calls = []

    def align(*inputs):
        calls.append(inputs)
        prep.PREP_LAUNCHES += 1
        fused_batch.TR_LAUNCHES += 5
        return result

    return align, calls


def _result(L=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    return base.AlignmentResult(torch.randn(6, generator=g), torch.randint(0, 50, (L,), generator=g, dtype=torch.int32),
                                *(torch.rand(L, generator=g) for _ in range(4)))


def test_pair_graph_bookkeeping(fake_cuda_graph):
    """A new key: the call runs eagerly (its result returned, its launches
    counted), then the capture, which counts nothing; the same key: a
    replay, which counts the captured launches, and views of one clone of
    the flat result in AlignmentResult's dtypes, which a later replay does
    not change; another key captures again."""
    want = _result()
    align, calls = _counting_align(want)
    inputs = (torch.zeros(60, 80, dtype=U8), torch.ones(60, 80), torch.zeros(60, 80, dtype=U8), torch.ones(60, 80),
              torch.zeros(6))
    key = ("config", "intrinsics")
    graph = base.PairGraph()
    before = (prep.PREP_LAUNCHES, fused_batch.TR_LAUNCHES, base.GRAPH_CAPTURES, base.GRAPH_REPLAYS)

    first = graph.run(align, inputs, key)
    assert first is want and len(calls) == 2
    assert calls[0] == inputs and all(b is graph.inputs[s] for b, s in zip(calls[1], graph.SLOTS))
    assert (prep.PREP_LAUNCHES, fused_batch.TR_LAUNCHES, base.GRAPH_CAPTURES, base.GRAPH_REPLAYS) == (
        before[0] + 1, before[1] + 5, before[2] + 1, before[3])

    kept = graph.run(align, inputs, key)
    assert len(calls) == 2 and _FakeGraph.replays == 1
    _assert_equal(kept, want)
    assert kept.state.untyped_storage().data_ptr() != graph.out.untyped_storage().data_ptr()
    assert (prep.PREP_LAUNCHES, fused_batch.TR_LAUNCHES, base.GRAPH_CAPTURES, base.GRAPH_REPLAYS) == (
        before[0] + 2, before[1] + 10, before[2] + 1, before[3] + 1)
    graph.out.zero_()
    graph.run(align, inputs, key)
    _assert_equal(kept, want)

    graph.run(align, inputs, ("another config", "intrinsics"))
    assert len(calls) == 4 and base.GRAPH_CAPTURES == before[2] + 2


def test_pair_graph_runs_on_the_inputs_card(fake_cuda_graph):
    """A pair's capture and its replays run with the inputs' card as the
    current device, the capture on a stream of that card, and the current
    card is as it was once the call returns: an object API on a card other
    than the current one captures where its kernels launch."""
    align, _ = _counting_align(_result())
    inputs = (torch.zeros(60, 80, dtype=U8), torch.ones(60, 80), torch.zeros(60, 80, dtype=U8), torch.ones(60, 80),
              torch.zeros(6))
    graph = base.PairGraph()
    for _ in range(3):
        graph.run(align, inputs, ("config", "intrinsics"))
    card = inputs[0].device
    assert _FakeGraph.seen == [("capture", card, card), ("replay", card), ("replay", card)]
    assert _FakeCard.current is None


def test_pair_graph_stages_into_matching_buffers():
    """stage copies into the slot's buffer where its shape and dtype
    match, and refuses (None) where they do not."""
    graph = base.PairGraph()
    assert graph.stage("source", torch.ones(4, 5)) is None
    buf = graph.inputs["source"] = torch.zeros(4, 5)
    assert graph.stage("source", torch.full((4, 5), 2.0)) is buf and torch.equal(buf, torch.full((4, 5), 2.0))
    assert graph.stage("source", buf) is buf
    assert graph.stage("source", torch.ones(4, 6)) is None
    assert graph.stage("source", torch.ones(4, 5, dtype=torch.float64)) is None
    assert torch.equal(buf, torch.full((4, 5), 2.0))


def test_object_api_routes_capturable_calls_through_the_graph(pairs, fake_cuda_graph, monkeypatch):
    """Where capturable says yes, optimize() runs the pair through the
    graph (eagerly at its first call, a replay after), set_* stage into the
    graph's buffers, and a call that is not capturable drops the graph and
    runs eagerly; every result is align_autodiff's."""
    monkeypatch.setattr(PhotoconsistencyOdometryAutodiff, "capturable", lambda self, *a: self.jacobian_mode == "linearizer")
    vo = PhotoconsistencyOdometryAutodiff(FAST, device="cpu")
    vo.set_intrinsic_matrix(K)
    captures, replays = base.GRAPH_CAPTURES, base.GRAPH_REPLAYS

    _assert_equal(_run(vo, pairs[0]), _eager(pairs[0], FAST))
    graph = vo._graph
    assert graph is not None and base.GRAPH_CAPTURES == captures + 1
    # the fake replay keeps the captured call's values: the same pair again
    _assert_equal(_run(vo, pairs[0]), _eager(pairs[0], FAST))
    assert base.GRAPH_REPLAYS == replays + 1
    assert vo._source[0] is graph.inputs["source"] and vo._init_state is graph.inputs["init"]
    assert torch.equal(graph.inputs["target"], torch.from_numpy(pairs[0][2]))

    vo.set_min_depth(0.5)  # a new key: captured again, eagerly first
    _assert_equal(_run(vo, pairs[1]), _eager(pairs[1], vo.config))
    assert base.GRAPH_CAPTURES == captures + 2 and vo._graph is graph

    vo.jacobian_mode = "jacfwd"
    got = _run(vo, pairs[1])
    assert vo._graph is None
    si, sd, ti, td, init = (torch.from_numpy(np.asarray(x)) for x in pairs[1])
    _assert_equal(got, align_autodiff(si, sd, ti, td, INTR, init, vo.config, "jacfwd"))
    assert (base.GRAPH_CAPTURES, base.GRAPH_REPLAYS) == (captures + 2, replays + 1)
