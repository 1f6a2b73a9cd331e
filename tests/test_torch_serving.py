"""Batched alignment and single-device multi-stream serving: phovo_tpu_torch's
parallel/batch.py (align_batch, align_sequences, serve_sequences_chunk,
align_sequences_multi) and models/analytic.py's align_batch_fused against
phovo_tpu's on the CPU, on the same numpy frames (make_sequence streams at
96x128 with an 8-pixel depth-less border, tests/test_torch_analytic.py's
schedule; 48x64 for phovo_tpu's multi-stream kernel in interpret mode,
whose banded row window is the whole image at H <= 48).

On the CPU phovo_tpu vmaps align_analytic (its XLA route) over the streams
or pairs; the port runs the level kernel's plain version level-major.
Tolerances: tests/test_torch_analytic.py's, states 2e-4 absolute, cost
1e-4 relative (2e-3 against the multi-stream kernel, see MULTI_COST_RTOL),
iteration and valid counts equal; poses 2e-4. A served
stream is the port's own align_sequence of that stream, bit for bit.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from phovo_tpu.models.analytic import align_batch_fused as jax_align_batch_fused
from phovo_tpu.ops.camera import Intrinsics as JIntrinsics
from phovo_tpu.parallel import batch as jbatch
from phovo_tpu.utils.config import PhovoConfig as JConfig
from phovo_tpu_torch.models import analytic as tan
from phovo_tpu_torch.models import base
from phovo_tpu_torch.ops import fused as tfused
from phovo_tpu_torch.ops import fused_batch as FB
from phovo_tpu_torch.ops import prep
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.prep import chunk_device_prep
from phovo_tpu_torch.parallel import batch as tbatch
from phovo_tpu_torch.utils.config import PhovoConfig
from phovo_tpu_torch.utils.synthetic import make_sequence

torch.set_num_threads(1)

INTR = Intrinsics(128.0, 128.0, 63.5, 47.5)
# a second camera of the rig
INTR_B = Intrinsics(120.0, 124.0, 64.0, 47.0)
DEPTH_SCALE = 1.0 / 5000.0
S, T = 3, 3
BASE = dict(
    num_levels=3, blur_filter_sizes=(0,) * 3, gradient_scales=(0.0625,) * 3,
    max_iterations=(3, 3, 4), lambda_steps=(1.0,) * 3, min_gradient_norms=(0.0,) * 3,
    sampling="bilinear",
)
# phovo_tpu's multi-stream kernel in interpret mode: 48x64 and 24x32, two
# iterations a level. Its costs there are ~1e-6 a pixel, so a state 1e-5
# apart moves them by up to 1.8e-3 (measured): they are held to MULTI_COST_RTOL
MULTI_COST_RTOL = 2e-3
MULTI = dict(BASE, num_levels=2, gradient_scales=(0.0625,) * 2, blur_filter_sizes=(0,) * 2,
             max_iterations=(2, 2), lambda_steps=(1.0,) * 2, min_gradient_norms=(0.0,) * 2)


def _cfgs(**kw):
    d = dict(BASE, **kw)
    return JConfig(**d), PhovoConfig(**d)


def _jintr(c):
    return JIntrinsics(*(np.float32(v) for v in c))


def _streams(intr, shape, s=S, t=T, border=8):
    """(s, t) make_sequence frames a stream, a depth-less border."""
    I, D = [], []
    for k in range(s):
        Ik, Dk, _, _ = make_sequence(intr, shape, t, seed=10 + k)
        I.append(np.stack(Ik))
        D.append(np.stack(Dk))
    I, D = np.stack(I), np.stack(D)
    D[..., :border, :] = D[..., -border:, :] = 0.0
    D[..., :border] = D[..., -border:] = 0.0
    return np.round(I * 255.0).astype(np.uint8), D


@pytest.fixture(scope="module")
def frames():
    return _streams(INTR, (96, 128))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return jax.tree.map(np.asarray, jax.device_get(x))


def _assert_match(port, ref, cost_rtol=1e-4):
    np.testing.assert_allclose(port.state.numpy(), ref.state, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(port.iterations.numpy(), ref.iterations)
    np.testing.assert_array_equal(port.num_valid.numpy(), ref.num_valid)
    np.testing.assert_allclose(port.cost.numpy(), ref.cost, rtol=cost_rtol)
    assert float(port.band_masked.abs().sum()) == 0.0


@pytest.mark.parametrize("use_fused,variant", [
    (True, {}), (True, dict(robust_loss="tdist", robust_delta=0.1)), (True, dict(gradient_at="esm")),
    (False, {}),
])
def test_align_batch_matches_jax(frames, use_fused, variant):
    """B pairs from seeded per-pair inits: the level kernel's plain version
    at B (use_fused), or the exact path pair after pair."""
    I, D = frames[0].reshape(-1, 96, 128), frames[1].reshape(-1, 96, 128)
    init = (np.random.default_rng(3).standard_normal((4, 6)) * 2e-3).astype(np.float32)
    jcfg, tcfg = _cfgs(**variant)
    args = (I[:4], D[:4], I[1:5], D[1:5])
    ref = _np(jbatch.align_batch(*map(jnp.asarray, args), _jintr(INTR), jnp.asarray(init), jcfg, use_fused))
    before = FB.LAUNCHES
    port = tbatch.align_batch(*map(_t, args), INTR, _t(init), tcfg, use_fused)
    assert FB.LAUNCHES == before
    _assert_match(port, ref)


@pytest.mark.parametrize("warm_start", [False, True])
def test_align_sequences_matches_jax(frames, warm_start):
    jcfg, tcfg = _cfgs()
    ref, ref_poses = _np(jbatch.align_sequences(jnp.asarray(frames[0]), jnp.asarray(frames[1]), _jintr(INTR), jcfg,
                                                warm_start=warm_start))
    port, poses = tbatch.align_sequences(_t(frames[0]), _t(frames[1]), INTR, tcfg, warm_start=warm_start)
    assert port.state.shape == (S, T - 1, 6) and poses.shape == (S, T - 1, 4, 4)
    _assert_match(port, ref)
    np.testing.assert_allclose(poses.numpy(), ref_poses, rtol=0, atol=2e-4)


def test_two_camera_rig_matches_jax_vmap():
    """Per-stream intrinsics: the port groups the streams by camera, one
    level-major batch a camera; phovo_tpu vmaps over (S,) intrinsic
    vectors."""
    IA, DA = _streams(INTR, (96, 128), s=2)
    IB, DB = _streams(INTR_B, (96, 128), s=2)
    order = [0, 2, 1, 3]  # cameras A, B, A, B
    I, D = np.concatenate([IA, IB])[order], np.concatenate([DA, DB])[order]
    cams = [INTR, INTR_B, INTR, INTR_B]
    jcfg, tcfg = _cfgs()
    jcams = JIntrinsics(*(jnp.asarray(np.array(v, np.float32)) for v in zip(*cams)))
    ref, ref_poses = _np(jbatch.align_sequences(jnp.asarray(I), jnp.asarray(D), jcams, jcfg))
    port, poses = tbatch.align_sequences(_t(I), _t(D), cams, tcfg)
    _assert_match(port, ref)
    np.testing.assert_allclose(poses.numpy(), ref_poses, rtol=0, atol=2e-4)
    # each camera's streams are their own batch: the bits of the camera alone
    alone, _ = tbatch.align_sequences(_t(I[[1, 3]]), _t(D[[1, 3]]), INTR_B, tcfg)
    assert torch.equal(port.state[[1, 3]], alone.state)


@pytest.mark.parametrize("new_frames,warm_start", [
    pytest.param(T - 1, False, id="False"), pytest.param(T - 1, True, id="True"),
    pytest.param(1, False, id="one_frame-False"), pytest.param(1, True, id="one_frame-True"),
])
def test_serve_sequences_chunk_matches_jax(frames, new_frames, warm_start):
    """One streaming step of S streams: uint8 carries and frames, uint16
    depth counts converted on the device with depth_scale; T - 1 new
    frames a stream, or one (phovo-serve --chunk 1: one pair a stream)."""
    I8 = frames[0]
    D16 = np.round(frames[1] / DEPTH_SCALE).astype(np.uint16)
    carry_d = D16[:, 0].astype(np.float32) * np.float32(DEPTH_SCALE)
    args = (I8[:, 0], carry_d, I8[:, 1:1 + new_frames], D16[:, 1:1 + new_frames])
    jcfg, tcfg = _cfgs()
    ref, ref_poses, jci, jcd = _np(jbatch.serve_sequences_chunk(
        *map(jnp.asarray, args), _jintr(INTR), jcfg, warm_start=warm_start, depth_scale=DEPTH_SCALE))
    port, poses, ci, cd = tbatch.serve_sequences_chunk(
        *map(_t, args), INTR, tcfg, warm_start=warm_start, depth_scale=DEPTH_SCALE)
    assert port.state.shape == (S, new_frames, 6)
    _assert_match(port, ref)
    np.testing.assert_allclose(poses.numpy(), ref_poses, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(ci.numpy(), jci)
    np.testing.assert_array_equal(cd.numpy(), jcd)


@pytest.mark.parametrize("variant", [{}, dict(robust_loss="tdist", robust_delta=0.1), dict(gradient_at="source")])
def test_served_stream_is_its_own_chain(frames, variant):
    """Each served stream is the port's align_sequence of that stream, bit
    for bit: the zero-init flatten (tdist too), and the exact path's serial
    pairs."""
    _, tcfg = _cfgs(**variant)
    res, _ = tbatch.align_sequences(_t(frames[0]), _t(frames[1]), INTR, tcfg)
    for s in range(S):
        own = tan.align_sequence(_t(frames[0][s]), _t(frames[1][s]), INTR, tcfg)
        for a, b in zip(res, own):
            assert torch.equal(a[s], b)


# One-frame rounds (phovo-serve --chunk 1) of S = 3 cameras at 60x80 over
# the benchmark's rendered sequence and its fleet configuration. Against
# the plain reference (benchmark/reference/vo.py), each pair's state is held
# to FLEET_STATE_ATOL, the limit the benchmark holds the median state gap
# to: the CPU runs the level kernel's plain version, whose sums are the
# reference's, so the gap reads 0 here, while the reference with its packs
# rounded to bfloat16 (the benchmark's control) lands 1e-2 to 0.25 away;
# iteration counts are equal and valid-pixel counts within FLEET_VALID_RTOL,
# the benchmark's valid-gap limit on the ceres cells.
FLEET_OFFSETS = (0, 4, 9)
FLEET_ROUNDS = 4
FLEET_STATE_ATOL = 1e-5
FLEET_VALID_RTOL = 3e-3


@pytest.fixture(scope="module")
def fleet():
    """The fleet cell's configuration cut to 60x80 and 12 frames, and its
    sequence rendered from a seed: uint8 intensity, uint16 depth counts."""
    from benchmark import run
    from benchmark.traffic.generator import make_sequence as render

    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    _, config, mix, _ = run.cell_files(bench, "analytic5.fleet")
    run.apply_overrides(config, mix, {"shape": (60, 80), "frames": 12})
    return config, render(mix["scene"], config["camera"], 2**33 + 5, torch.device("cpu"))


def _fleet_within_tolerance(answers, ref) -> bool:
    states, its, valid = answers
    rv = ref[2].astype(np.float64)
    return bool(np.abs(states - ref[0]).max() <= FLEET_STATE_ATOL and (its == ref[1]).all()
                and (np.abs(valid - rv) / np.maximum(rv, 1.0)).max() <= FLEET_VALID_RTOL)


def test_one_frame_rounds_are_each_streams_own_chain(fleet):
    """FLEET_ROUNDS rounds of one new frame a stream through
    serve_sequences_chunk, each round's carries the round before's: every
    stream's pairs are its own align_sequence_chunk chain, bit for bit, and
    every pair meets the plain reference, which the bfloat16 control does
    not."""
    from benchmark import check

    config, (I8, D16) = fleet
    N, cam = len(I8), config["camera"]
    intr = Intrinsics(*(float(np.float32(cam[k])) for k in ("fx", "fy", "cx", "cy")))
    cfg = PhovoConfig.from_dict(config["preset"])
    scale = 1.0 / cam["depth_counts_per_m"]
    offsets = np.array(FLEET_OFFSETS)

    def metres(d16):
        return _t(d16).to(torch.float32) * float(np.float32(scale))

    ci, cd = _t(I8[offsets]), metres(D16[offsets])
    rounds = []
    for k in range(1, FLEET_ROUNDS + 1):
        now = (offsets + k) % N
        res, poses, ci, cd = tbatch.serve_sequences_chunk(ci, cd, _t(I8[now][:, None]), _t(D16[now][:, None]), intr,
                                                          cfg, depth_scale=scale)
        assert res.state.shape == (len(offsets), 1, 6) and poses.shape == (len(offsets), 1, 4, 4)
        rounds.append(res)
    served = res._replace(**{f: torch.cat([getattr(r, f) for r in rounds], dim=1)
                             for f in ("state", "iterations", "gradient_norm", "cost", "num_valid")})
    pairs = []
    for s, o in enumerate(offsets):
        frames = (o + np.arange(FLEET_ROUNDS + 1)) % N
        own, _, _ = tan.align_sequence_chunk(_t(I8[o]), metres(D16[o]), _t(I8[frames[1:]]), _t(D16[frames[1:]]),
                                             intr, cfg, depth_scale=scale)
        assert all(torch.equal(getattr(served, f)[s], getattr(own, f))
                   for f in ("state", "iterations", "gradient_norm", "cost", "num_valid"))
        pairs += list(zip(frames[:-1], frames[1:]))
    pairs = np.array(pairs)
    answers = (served.state.reshape(-1, 6).numpy(), served.iterations.reshape(-1, cfg.num_levels).numpy(),
               served.num_valid.reshape(-1, cfg.num_levels).numpy())
    ref = check.reference_answers(pairs, (I8, D16), config, torch.device("cpu"))
    control = check.reference_answers(pairs, (I8, D16), config, torch.device("cpu"), torch.bfloat16)
    assert _fleet_within_tolerance(answers, ref)
    assert not _fleet_within_tolerance(control, ref)


# The round graph's route (parallel/batch.RoundGraph): which rounds would
# replay a CUDA graph on the card, that every round here runs launch by
# launch with the parent's bits, and the graph's bookkeeping with
# torch.cuda's graph replaced by a stand-in. The card replays the real
# graph (tests/test_torch_graph_cuda.py).
U8, U16, F32 = torch.uint8, torch.uint16, torch.float32
SHARED_RIG = [INTR] * S


def _round_tensors(device, dtypes, streams=S, new=1, shape=(96, 128)):
    """A round's carries and `new` new frames a stream (new None: one, as
    (S, H, W)), ((carry, new) intensity dtypes, (carry, new) depth
    dtypes), on `device` with no data: fake tensors
    where the device is a card, so the rule is asked here as the card's
    calls ask it."""
    (ci, i), (cd, d) = dtypes
    frames = (streams, *shape) if new is None else (streams, new, *shape)
    specs = [((streams, *shape), ci), ((streams, *shape), cd), (frames, i), (frames, d)]
    with FakeTensorMode() if torch.device(device).type == "cuda" else contextlib.nullcontext():
        return [torch.empty(size, dtype=dtype, device=device) for size, dtype in specs]


@pytest.mark.parametrize("device,intr,variant,dtypes,kw,want", [
    ("cuda", INTR, {}, ((U8, U8), (F32, U16)), dict(depth_scale=DEPTH_SCALE), True),
    ("cuda:0", INTR, {}, ((F32, U8), (F32, U16)), dict(depth_scale=DEPTH_SCALE), True),
    ("cuda", INTR, dict(robust_loss="tdist", robust_delta=0.1), ((F32, F32), (F32, F32)), {}, True),
    ("cuda", INTR, dict(gradient_at="esm"), ((F32, U8), (F32, F32)), {}, True),
    ("cuda", SHARED_RIG, {}, ((F32, U8), (F32, U16)), dict(depth_scale=DEPTH_SCALE), True),
    ("cpu", INTR, {}, ((F32, U8), (F32, U16)), dict(depth_scale=DEPTH_SCALE), False),
    ("cuda", INTR, {}, ((F32, U8), (F32, U16)), dict(depth_scale=DEPTH_SCALE, warm_start=True), False),
    ("cuda", INTR, {}, ((F32, U8), (F32, U16)), dict(depth_scale=DEPTH_SCALE, use_fused=False), False),
    ("cuda", INTR, dict(gradient_at="source"), ((F32, U8), (F32, U16)), dict(depth_scale=DEPTH_SCALE), False),
    ("cuda", [INTR, INTR_B, INTR], {}, ((F32, U8), (F32, U16)), dict(depth_scale=DEPTH_SCALE), False),
    ("cuda", INTR, dict(blur_filter_sizes=(0, 3, 0)), ((F32, U8), (F32, U16)), dict(depth_scale=DEPTH_SCALE), False),
    ("cuda", INTR, {}, ((F32, U8), (F32, U16)), {}, False),
    ("cuda", INTR, {}, ((F32, torch.float64), (F32, F32)), {}, False),
    ("cuda:1", INTR, {}, ((F32, U8), (F32, U16)), dict(depth_scale=DEPTH_SCALE), True),
])
def test_round_capturable_rule(device, intr, variant, dtypes, kw, want):
    """A round replays a graph only on a CUDA card (any card, not only the
    current one), zero-init on the level kernel's route, with one camera
    for every stream and frames K-PREP takes in their dtypes (uint16 depth
    with its depth_scale): never with warm_start, the exact path, two
    cameras, a blurred level or other dtypes."""
    _, tcfg = _cfgs(**variant)
    tensors = _round_tensors(device, dtypes)
    assert tbatch.round_capturable(*tensors, intr, tcfg, **kw) is want


@pytest.mark.parametrize("case", ["two_cards", "carry_on_the_host", "three_dims", "empty", "plain_level"])
def test_round_capturable_refuses_other_rounds(monkeypatch, case):
    """The rule answers for the tensors themselves: carries on another card
    or on the host, new frames that are not (S, B, H, W) or are empty, and
    a round whose level is a plain version put in the K-GN wrapper's place
    (as a comparison against it does) run launch by launch."""
    _, tcfg = _cfgs()
    dtypes = ((F32, U8), (F32, U16))
    tensors = _round_tensors("cuda", dtypes)
    if case == "two_cards":
        tensors[1] = _round_tensors("cuda:1", dtypes)[1]
    elif case == "carry_on_the_host":
        tensors[0] = _round_tensors("cpu", dtypes)[0]
    elif case == "three_dims":
        tensors = _round_tensors("cuda", dtypes, new=None)
    elif case == "empty":
        tensors = _round_tensors("cuda", dtypes, new=0)
    else:
        monkeypatch.setattr(tan, "fused_gn_level_batch", FB.fused_gn_level_batch_reference)
    assert tbatch.round_capturable(*tensors, INTR, tcfg, depth_scale=DEPTH_SCALE) is False


def _parent_round(ci, cd, I, D, intr, cfg, use_fused=True, warm_start=False, depth_scale=None):
    """serve_sequences_chunk's round as it ran before the round graph: each
    stream's conversion and carry prepend, the stacks, align_sequences."""
    prepped = [chunk_device_prep(*x, depth_scale) for x in zip(ci, cd, I, D)]
    I, D = torch.stack([p[0] for p in prepped]), torch.stack([p[1] for p in prepped])
    res, poses = tbatch.align_sequences(I, D, intr, cfg, use_fused, warm_start)
    return res, poses, I[:, -1], D[:, -1]


def _assert_round_equal(got, want):
    for g, w in zip((*got[0], *got[1:]), (*want[0], *want[1:])):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)


def _round_counts():
    return base.ROUND_GRAPH_CAPTURES, base.ROUND_GRAPH_REPLAYS


def _fleet_round_inputs(fleet, k, offsets=FLEET_OFFSETS, carry=None):
    """Round k's inputs of the fleet cut to 60x80: the carries (uint8 and
    metres, or `carry`), the new frames in storage dtype, intrinsics,
    config and depth_scale."""
    config, (I8, D16) = fleet
    cam = config["camera"]
    intr = Intrinsics(*(float(np.float32(cam[c])) for c in ("fx", "fy", "cx", "cy")))
    scale = 1.0 / cam["depth_counts_per_m"]
    last, now = (np.array(offsets) + k - 1) % len(I8), (np.array(offsets) + k) % len(I8)
    if carry is None:
        carry = (_t(I8[last]), _t(D16[last]).to(torch.float32) * float(np.float32(scale)))
    return (*carry, _t(I8[now][:, None]), _t(D16[now][:, None])), intr, PhovoConfig.from_dict(config["preset"]), scale


@pytest.mark.parametrize("case", ["cpu", "warm_start", "two_cameras", "blurred"])
def test_rounds_here_run_launch_by_launch(fleet, monkeypatch, case):
    """Rounds on the CPU (and, on the card too, warm-started rounds, two
    cameras and a blurred preset) never reach the round graph: the round
    counters stay as they were, and each round, the first from a uint8
    carry and the next from the returned carries, gives the parent's round
    bit for bit."""

    def refuse(*a):
        raise AssertionError("a CPU round reached the round graph")

    monkeypatch.setattr(tbatch._ROUND_GRAPH, "run", refuse)
    before = _round_counts()
    carry = None
    for k in (1, 2):
        inputs, intr, cfg, scale = _fleet_round_inputs(fleet, k, carry=carry)
        kw = dict(depth_scale=scale)
        if case == "warm_start":
            kw["warm_start"] = True
        elif case == "two_cameras":
            intr = [intr, intr._replace(fx=intr.fx * 1.02), intr]
        elif case == "blurred":
            cfg = dataclasses.replace(cfg, blur_filter_sizes=(0, 0, 3, 0, 0))
        got = tbatch.serve_sequences_chunk(*inputs, intr, cfg, **kw)
        _assert_round_equal(got, _parent_round(*inputs, intr, cfg, **kw))
        carry = got[2:]
    assert carry[0].dtype == torch.float32 and _round_counts() == before


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph on the CPU: the block in
    torch.cuda.graph runs (its ops compute there, on the captured round),
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
def fake_card_graph(monkeypatch):
    """torch.cuda's graph, capture, stream and current card by the
    stand-ins above, and the route answering yes."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    monkeypatch.setattr(torch.cuda, "device", _FakeCard)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(tbatch, "round_capturable", lambda *a, **kw: True)
    _FakeGraph.seen = []


def test_round_graph_bookkeeping(fleet, fake_card_graph, monkeypatch):
    """With the rule answering yes and a stand-in graph: a new key (the
    first round's uint8 carry, then float32 carries, then fewer streams)
    runs the round eagerly, returns its result and captures, which counts
    no launch; the same key stages the carries and frames into the graph's
    buffers and replays, which counts the captured launches; a replay
    returns the results and the carries as clones in two groups, which a
    later replay does not change."""
    graph = tbatch.RoundGraph()
    monkeypatch.setattr(tbatch, "_ROUND_GRAPH", graph)
    calls, eager = [], tbatch._serve_round

    def counting_round(*args):  # one K-PREP and three K-GN launches, as a round on the card
        calls.append(args)
        prep.PREP_LAUNCHES += 1
        FB.LAUNCHES += 3
        return eager(*args)

    monkeypatch.setattr(tbatch, "_serve_round", counting_round)

    def counts():
        return (*_round_counts(), prep.PREP_LAUNCHES, FB.LAUNCHES, len(calls))

    inputs, intr, cfg, scale = _fleet_round_inputs(fleet, 1)
    before = counts()
    first = tbatch.serve_sequences_chunk(*inputs, intr, cfg, depth_scale=scale)
    _assert_round_equal(first, _parent_round(*inputs, intr, cfg, depth_scale=scale))
    assert counts() == (before[0] + 1, before[1], before[2] + 1, before[3] + 3, 2)
    assert all(b is graph.inputs[slot] for b, slot in zip(calls[1][:4], graph.SLOTS))

    inputs, *_ = _fleet_round_inputs(fleet, 2, carry=first[2:])
    want = _parent_round(*inputs, intr, cfg, depth_scale=scale)
    _assert_round_equal(tbatch.serve_sequences_chunk(*inputs, intr, cfg, depth_scale=scale), want)
    assert counts() == (before[0] + 2, before[1], before[2] + 2, before[3] + 6, 4)

    # the stand-in replays the captured round's values: the same inputs again
    kept = tbatch.serve_sequences_chunk(*inputs, intr, cfg, depth_scale=scale)
    _assert_round_equal(kept, want)
    assert counts() == (before[0] + 2, before[1] + 1, before[2] + 3, before[3] + 9, 4) and _FakeGraph.replays >= 1
    storages = {t.untyped_storage().data_ptr() for t in (*kept[0], kept[1])}
    assert len(storages) == 1 and kept[2].untyped_storage().data_ptr() == kept[3].untyped_storage().data_ptr()
    assert kept[2].untyped_storage().data_ptr() not in storages | {graph.out.untyped_storage().data_ptr()}
    graph.out.zero_()
    tbatch.serve_sequences_chunk(*inputs, intr, cfg, depth_scale=scale)
    _assert_round_equal(kept, want)

    later, *_ = _fleet_round_inputs(fleet, 3, carry=kept[2:])
    tbatch.serve_sequences_chunk(*later, intr, cfg, depth_scale=scale)
    assert all(torch.equal(graph.inputs[slot], t) for slot, t in zip(graph.SLOTS, later))
    assert counts()[:2] == (before[0] + 2, before[1] + 3)

    fewer, *_ = _fleet_round_inputs(fleet, 3, offsets=FLEET_OFFSETS[:2])
    tbatch.serve_sequences_chunk(*fewer, intr, cfg, depth_scale=scale)
    assert counts()[:2] == (before[0] + 3, before[1] + 3) and len(calls) == 6


def test_round_graph_runs_on_the_inputs_card(fleet, fake_card_graph, monkeypatch):
    """The round's capture and its replays run with the inputs' card as the
    current device, the capture on a stream of that card, and the current
    card is as it was once the call returns: a round on a card other than
    the current one is captured where its kernels launch."""
    monkeypatch.setattr(tbatch, "_ROUND_GRAPH", tbatch.RoundGraph())
    inputs, intr, cfg, scale = _fleet_round_inputs(fleet, 1)
    carry = tbatch.serve_sequences_chunk(*inputs, intr, cfg, depth_scale=scale)[2:]
    inputs, *_ = _fleet_round_inputs(fleet, 2, carry=carry)
    for _ in range(2):
        tbatch.serve_sequences_chunk(*inputs, intr, cfg, depth_scale=scale)
    card = inputs[2].device
    assert _FakeGraph.seen == [("capture", card, card), ("capture", card, card), ("replay", card)]
    assert _FakeCard.current is None


@pytest.fixture(scope="module")
def small_streams():
    return _streams(INTR.at_level(1), (48, 64), border=4)


def test_align_batch_fused_matches_jax(small_streams):
    """S pairs through one multi-stream level per active level (the B7
    route) against phovo_tpu's align_batch_fused with its kernels in
    interpret mode."""
    I, D = small_streams[0][:, 0], small_streams[1][:, 0]
    It, Dt = small_streams[0][:, 1], small_streams[1][:, 1]
    init = (np.random.default_rng(4).standard_normal((S, 6)) * 1e-3).astype(np.float32)
    cfg = dict(MULTI, robust_loss="huber", robust_delta=0.02)
    ref = _np(jax_align_batch_fused(*map(jnp.asarray, (I, D, It, Dt)), _jintr(INTR.at_level(1)),
                                    jnp.asarray(init), JConfig(**cfg), interpret=True))
    before = tfused.MULTI_LAUNCHES
    port = tan.align_batch_fused(*map(_t, (I, D, It, Dt)), INTR.at_level(1), _t(init), PhovoConfig(**cfg))
    assert tfused.MULTI_LAUNCHES == before
    _assert_match(port, ref, MULTI_COST_RTOL)


def test_align_sequences_multi_matches_jax(small_streams):
    """align_sequences_multi (a loop over time, one align_batch_fused a
    step), warm-started, against phovo_tpu's in interpret mode; the same
    streams through align_sequences for the contract (shapes, poses)."""
    I, D = small_streams
    intr = INTR.at_level(1)
    ref, ref_poses = _np(jbatch.align_sequences_multi(jnp.asarray(I), jnp.asarray(D), _jintr(intr),
                                                      JConfig(**MULTI), warm_start=True, interpret=True))
    port, poses = tbatch.align_sequences_multi(_t(I), _t(D), intr, PhovoConfig(**MULTI), warm_start=True)
    assert port.state.shape == (S, T - 1, 6) and poses.shape == (S, T - 1, 4, 4)
    _assert_match(port, ref, MULTI_COST_RTOL)
    np.testing.assert_allclose(poses.numpy(), ref_poses, rtol=0, atol=2e-4)
    zero, _ = tbatch.align_sequences_multi(_t(I), _t(D), intr, PhovoConfig(**MULTI))
    chain, _ = tbatch.align_sequences(_t(I), _t(D), intr, PhovoConfig(**MULTI))
    np.testing.assert_allclose(zero.state.numpy(), chain.state.numpy(), rtol=0, atol=2e-4)


def test_multi_route_takes_float_streams(small_streams):
    """float32 frames (each time step a strided view of the (S, T, H, W)
    stack) give the bits of the same frames in uint8, through
    align_sequences_multi and align_batch."""
    I, D = small_streams
    intr = INTR.at_level(1)
    cfg = PhovoConfig(**MULTI)
    If = tan.device_unit_intensity(_t(I))
    ref, _ = tbatch.align_sequences_multi(_t(I), _t(D), intr, cfg)
    port, _ = tbatch.align_sequences_multi(If, _t(D), intr, cfg)
    assert all(torch.equal(a, b) for a, b in zip(port, ref))
    init = torch.zeros((S, 6))
    one = tbatch.align_batch(If[:, 0], _t(D)[:, 0], If[:, 1], _t(D)[:, 1], intr, init, cfg, use_fused=True)
    assert torch.equal(one.state, ref.state[:, 0])


def test_multi_route_refuses_tdist_and_cpu_launches_nothing(small_streams):
    I, D = small_streams
    cfg = PhovoConfig(**dict(MULTI, robust_loss="tdist"))
    assert not tan.multi_kernel_eligible(cfg) and tan.multi_kernel_eligible(PhovoConfig(**MULTI))
    with pytest.raises(ValueError, match="tdist"):
        tbatch.align_sequences_multi(_t(I), _t(D), INTR.at_level(1), cfg)
    with pytest.raises(ValueError, match="intrinsics for"):
        tbatch.align_sequences(_t(I), _t(D), [INTR] * (S - 1), PhovoConfig(**MULTI))
    before = (FB.LAUNCHES, FB.TR_LAUNCHES, tfused.MULTI_LAUNCHES)
    tbatch.align_sequences(_t(I), _t(D), INTR.at_level(1), PhovoConfig(**MULTI))
    assert (FB.LAUNCHES, FB.TR_LAUNCHES, tfused.MULTI_LAUNCHES) == before
