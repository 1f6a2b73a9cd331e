"""The object API's pair graph (models/base.PairGraph) on the card: the
ceres object API at 480x640 replays one CUDA graph of K-PREP, the five
K-TR levels and their glue, bit for bit what eager align_autodiff calls
give; a result it returned stays as it was after later pairs; a new
config, new intrinsics or a new frame shape captures once; the counters
count what ran; the blurred presets and the jacfwd mode never capture.

The serving round's graph (parallel/batch.RoundGraph) likewise: one new
480x640 frame a camera a round through serve_sequences_chunk, as
phovo-serve --chunk 1 and the fleet run it, replays the round bit for bit
what the round launch by launch gives; results and carries kept from a
round survive the rounds after it; another stream count or a shorter
round captures again; warm-started rounds, two cameras, a blurred preset
and a plain level put in the kernel's place never capture. On a host with
two cards, both graphs run on the second card while the first is current
(skipped with one card).

Needs an NVIDIA GPU and nvcc; skipped elsewhere. Run on the card with
    python -m pytest --noconftest -m cuda tests/test_torch_graph_cuda.py
(tests/conftest.py imports jax, which the port's machines need not have)."""

import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest
import torch

from phovo_tpu_torch.models import analytic, base
from phovo_tpu_torch.models.autodiff import PhotoconsistencyOdometryAutodiff, align_autodiff
from phovo_tpu_torch.ops import fused_batch, prep
from phovo_tpu_torch.ops.camera import TUM_FR1, Intrinsics
from phovo_tpu_torch.parallel import batch
from phovo_tpu_torch.utils.config import load_builtin
from phovo_tpu_torch.utils.synthetic import make_sequence

pytestmark = pytest.mark.cuda

CERES5 = load_builtin("config_5_level_optimization_ceres")  # unblurred, all five levels active
ACTIVE = sum(n > 0 for n in CERES5.max_iterations)
INITS = [np.zeros(6, np.float32), np.array([0.004, -0.002, 0.006, 0.002, -0.003, 0.001], np.float32)]


@pytest.fixture(autouse=True)
def card():
    """Skips where torch finds no card (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@functools.cache
def _frames(shape=(480, 640), n=8):
    """n consecutive synthetic frames as a camera hands them over: uint8
    intensity and float32 metres."""
    intensities, depths, _, _ = make_sequence(TUM_FR1, shape, n_frames=n)
    return ([np.round(np.asarray(I) * 255).astype(np.uint8) for I in intensities],
            [np.asarray(D, np.float32) for D in depths])


def _vo(config=CERES5, mode="linearizer", intr=TUM_FR1):
    vo = PhotoconsistencyOdometryAutodiff(config, mode)
    vo.set_intrinsic_matrix(np.asarray(intr.matrix()))
    return vo


def _pair(vo, si, sd, ti, td, init):
    vo.set_source_frame(si, sd)
    vo.set_target_frame(ti, td)
    vo.set_initial_state_vector(init)
    return vo.optimize()


def _eager(si, sd, ti, td, init, config=CERES5, intr=TUM_FR1, mode="linearizer", dev=torch.device("cuda")):
    si, sd, ti, td, init = (torch.as_tensor(x).to(dev) for x in (si, sd, ti, td, init))
    return align_autodiff(si, sd, ti, td, intr, init, config, mode)


def _assert_equal(got, want):
    for name, g, w in zip(base.AlignmentResult._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), f"{name}: {g.tolist()} against {w.tolist()}"


def _counts():
    return (base.GRAPH_CAPTURES, base.GRAPH_REPLAYS, prep.PREP_LAUNCHES, prep.PREP_TORCH_CALLS,
            fused_batch.TR_LAUNCHES)


def test_replayed_pairs_equal_eager_calls_and_count_what_ran():
    """Seven pairs of consecutive frames, each frame the next pair's
    source, from zero and nonzero states, one pair's source handed in as
    tensors on the card: the first pair captures, the other six replay;
    every result equals an eager align_autodiff call on the same inputs,
    and a replayed pair counts one K-PREP and five K-TR launches, as an
    eager pair does."""
    I, D = _frames()
    vo = _vo()
    for k in range(len(I) - 1):
        si, sd = I[k], D[k]
        if k == 3:
            si, sd = torch.from_numpy(si).cuda(), torch.from_numpy(sd).cuda()
        before = _counts()
        got = _pair(vo, si, sd, I[k + 1], D[k + 1], INITS[k % 2])
        after = _counts()
        torch.cuda.synchronize()
        assert after[:2] == ((before[0] + 1, before[1]) if k == 0 else (before[0], before[1] + 1)), k
        assert after[2:] == (before[2] + 1, before[3], before[4] + ACTIVE), k
        _assert_equal(got, _eager(I[k], D[k], I[k + 1], D[k + 1], INITS[k % 2]))


def test_a_kept_result_survives_later_pairs():
    """The object API hands back a clone of the graph's output: results
    kept from every pair are unchanged after the pairs that follow."""
    I, D = _frames()
    vo = _vo()
    kept, copies = [], []
    for k in range(4):
        res = _pair(vo, I[k], D[k], I[k + 1], D[k + 1], INITS[k % 2])
        kept.append(res)
        copies.append(base.AlignmentResult(*(x.clone() for x in res)))
        assert torch.equal(vo.get_optimal_state_vector(), res.state)
    torch.cuda.synchronize()
    for res, copy in zip(kept, copies):
        _assert_equal(res, copy)
    assert len({res.state.data_ptr() for res in kept}) == len(kept)


@pytest.mark.parametrize("change", ["min_depth", "intrinsics", "shape"])
def test_each_new_key_captures_once(change):
    """set_min_depth, new intrinsics and a new frame shape each capture one
    new graph; the pairs after it replay, and equal eager calls."""
    I, D = _frames()
    vo = _vo()
    for k in range(2):
        _pair(vo, I[k], D[k], I[k + 1], D[k + 1], INITS[0])
    config, intr = CERES5, TUM_FR1
    if change == "min_depth":
        vo.set_min_depth(0.5)
        config = dataclasses.replace(CERES5, min_depth=0.5)
    elif change == "intrinsics":
        intr = Intrinsics(520.0, 518.0, 320.5, 240.5)
        vo.set_intrinsic_matrix(np.asarray(intr.matrix()))
    else:
        I, D = _frames((240, 320))
    before = _counts()
    for k in range(3):
        got = _pair(vo, I[k], D[k], I[k + 1], D[k + 1], INITS[1])
        _assert_equal(got, _eager(I[k], D[k], I[k + 1], D[k + 1], INITS[1], config, intr))
    assert _counts()[:2] == (before[0] + 1, before[1] + 2)


@pytest.mark.parametrize("case", ["blurred", "jacfwd"])
def test_blurred_presets_and_jacfwd_never_capture(case):
    """A preset that blurs an active level (the torch prep chain) and the
    jacfwd mode run eagerly, as before: no capture, no replay, results
    equal to align_autodiff's."""
    if case == "blurred":
        config, mode, shape = load_builtin("config_3_level_optimization_ceres"), "linearizer", (480, 640)
    else:
        config, mode, shape = dataclasses.replace(CERES5, max_iterations=(0, 0, 2, 2, 3)), "jacfwd", (120, 160)
    I, D = _frames(shape, 3)
    vo = _vo(config, mode)
    before = _counts()
    for k in range(2):
        got = _pair(vo, I[k], D[k], I[k + 1], D[k + 1], INITS[k])
        _assert_equal(got, _eager(I[k], D[k], I[k + 1], D[k + 1], INITS[k], config, TUM_FR1, mode))
    assert _counts()[:2] == before[:2] and vo._graph is None


ANALYTIC5 = load_builtin("config_5_level_optimization_analytic")  # the fleet's preset: levels 2-4 active
ROUND_ACTIVE = sum(n > 0 for n in ANALYTIC5.max_iterations)
DEPTH_SCALE = 1.0 / 5000.0


@functools.cache
def _camera_frames(shape=(480, 640), n=10):
    """n frames as a camera fleet hands them over: uint8 intensity and
    uint16 depth counts at 5000 a metre."""
    I, D = _frames(shape, n)
    return np.stack(I), np.round(np.stack(D) / DEPTH_SCALE).astype(np.uint16)


def _round_inputs(k, cameras=4, new=1, carry=None, dev=torch.device("cuda")):
    """Round k of `cameras` cameras, camera c at frame c + k: the carries
    (uint8 and metres at k = 1, else `carry`) and `new` new frames a camera
    in storage dtype, on the card `dev`."""
    I8, D16 = _camera_frames()
    first = np.arange(cameras) + k * new - new
    if carry is None:
        carry = (torch.from_numpy(I8[first]).to(dev),
                 torch.from_numpy(D16[first]).to(dev).to(torch.float32) * float(np.float32(DEPTH_SCALE)))
    idx = (first[:, None] + 1 + np.arange(new)[None]) % len(I8)
    return (*carry, torch.from_numpy(I8[idx]).to(dev), torch.from_numpy(D16[idx]).to(dev))


def _serve(inputs, config=ANALYTIC5, intr=TUM_FR1, **kw):
    return batch.serve_sequences_chunk(*inputs, intr, config, depth_scale=DEPTH_SCALE, **kw)


def _eager_round(inputs, config=ANALYTIC5, intr=TUM_FR1, warm_start=False):
    """The round launch by launch (serve_sequences_chunk's work without the
    graph)."""
    return batch._serve_round(*inputs, intr, config, True, warm_start, DEPTH_SCALE)


def _assert_round_equal(got, want):
    _assert_equal(got[0], want[0])
    for name, g, w in zip(("poses", "carry intensity", "carry depth"), got[1:], want[1:]):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w), name


def _round_counts():
    return (base.ROUND_GRAPH_CAPTURES, base.ROUND_GRAPH_REPLAYS, prep.PREP_LAUNCHES, prep.PREP_TORCH_CALLS,
            fused_batch.LAUNCHES)


def test_replayed_rounds_equal_eager_rounds_and_count_what_ran():
    """Six rounds of four cameras, one new frame each: the first (a uint8
    carry) and the second (the returned float32 carries) capture, the other
    four replay; every round equals the round launch by launch on the same
    inputs, and counts one K-PREP launch and one K-GN launch a level, as an
    eager round does."""
    carry = None
    for k in range(1, 7):
        inputs = _round_inputs(k, carry=carry)
        before = _round_counts()
        got = _serve(inputs)
        after = _round_counts()
        torch.cuda.synchronize()
        assert after[:2] == ((before[0] + 1, before[1]) if k <= 2 else (before[0], before[1] + 1)), k
        assert after[2:] == (before[2] + 1, before[3], before[4] + ROUND_ACTIVE), k
        _assert_round_equal(got, _eager_round(inputs))
        carry = got[2:]
    assert carry[0].dtype == torch.float32


def test_kept_rounds_and_carries_survive_later_rounds():
    """A replay hands back clones: every round's results, poses and
    carries kept over five rounds are unchanged after the rounds that
    follow, and none shares memory with the graph or another round."""
    carry, kept, copies = None, [], []
    for k in range(1, 6):
        got = _serve(_round_inputs(k, carry=carry))
        kept.append(got)
        copies.append((base.AlignmentResult(*(x.clone() for x in got[0])), *(x.clone() for x in got[1:])))
        carry = got[2:]
    torch.cuda.synchronize()
    for got, copy in zip(kept, copies):
        _assert_round_equal(got, copy)
    graph = batch._ROUND_GRAPH.out.untyped_storage().data_ptr()
    ptrs = [t.untyped_storage().data_ptr() for got in kept[2:] for t in (got[0].state, got[2])]
    assert len(set(ptrs)) == len(ptrs) and graph not in ptrs


@pytest.mark.parametrize("change", ["streams", "shorter_round"])
def test_a_new_round_shape_captures_again(change):
    """After three rounds (two captures, one replay), three cameras instead
    of four, or a round of one new frame after rounds of two (phovo-serve's
    last, shorter chunk), captures once; the rounds after it replay, and
    every round equals the round launch by launch."""
    new = 2 if change == "shorter_round" else 1
    carry = None
    for k in range(1, 4):
        carry = _serve(_round_inputs(k, new=new, carry=carry))[2:]
    before = _round_counts()
    for k in range(4, 6):
        if change == "streams":
            inputs = _round_inputs(k, cameras=3, carry=tuple(c[:3] for c in carry))
        else:
            inputs = _round_inputs(k, new=1, carry=carry)
        got = _serve(inputs)
        _assert_round_equal(got, _eager_round(inputs))
        carry = got[2:]
    assert _round_counts()[:2] == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("case", ["warm_start", "two_cameras", "blurred"])
def test_rounds_that_cannot_capture_run_launch_by_launch(case):
    """Warm-started rounds, two cameras and a preset that blurs an active
    level run launch by launch on the card: no capture, no replay, each
    round the round launch by launch."""
    config, intr, kw = ANALYTIC5, TUM_FR1, {}
    if case == "warm_start":
        kw["warm_start"] = True
    elif case == "two_cameras":
        intr = [TUM_FR1, Intrinsics(520.0, 518.0, 320.5, 240.5), TUM_FR1, TUM_FR1]
    else:
        config = dataclasses.replace(ANALYTIC5, blur_filter_sizes=(0, 0, 3, 0, 0))
    before = _round_counts()
    carry = None
    for k in (1, 2):
        inputs = _round_inputs(k, carry=carry)
        got = _serve(inputs, config, intr, **kw)
        _assert_round_equal(got, _eager_round(inputs, config, intr, kw.get("warm_start", False)))
        carry = got[2:]
    assert _round_counts()[:2] == before[:2]


def test_a_plain_level_put_in_place_runs_launch_by_launch():
    """After rounds that captured and replayed, the same round with the
    plain K-GN put in the wrapper's place, as a comparison against the
    kernel does, runs launch by launch: no capture, no replay, no K-GN
    launch, and the plain version's results, not the graph's."""
    carry = None
    for k in range(1, 4):
        inputs = _round_inputs(k, carry=carry)
        carry = _serve(inputs)[2:]
    before = _round_counts()
    with mock.patch.object(analytic, "fused_gn_level_batch", fused_batch.fused_gn_level_batch_reference):
        got = _serve(inputs)
        want = _eager_round(inputs)
    after = _round_counts()
    assert after[:2] == before[:2] and after[4] == before[4]
    _assert_round_equal(got, want)


def _second_card():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card")
    torch.cuda.set_device(0)
    return torch.device("cuda", 1)


def test_rounds_on_a_second_card_replay_there():
    """Six rounds of four cameras on card 1 while card 0 is current: two
    captures, four replays, every round the round launch by launch on card
    1 (a graph captured on the current card's stream would be empty and
    hand back the captured round every time), and card 0 still current."""
    dev = _second_card()
    carry = None
    for k in range(1, 7):
        inputs = _round_inputs(k, carry=carry, dev=dev)
        before = _round_counts()
        got = _serve(inputs)
        after = _round_counts()
        assert after[:2] == ((before[0] + 1, before[1]) if k <= 2 else (before[0], before[1] + 1)), k
        assert got[0].state.device == dev and torch.cuda.current_device() == 0
        _assert_round_equal(got, _eager_round(inputs))
        carry = got[2:]


def test_pairs_on_a_second_card_replay_there():
    """The ceres object API on card 1 while card 0 is current: the first
    pair captures, the next four replay, each equal to an eager
    align_autodiff call on card 1, and card 0 still current."""
    dev = _second_card()
    I, D = _frames()
    vo = PhotoconsistencyOdometryAutodiff(CERES5, "linearizer", device=dev)
    vo.set_intrinsic_matrix(np.asarray(TUM_FR1.matrix()))
    before = _counts()
    for k in range(5):
        got = _pair(vo, I[k], D[k], I[k + 1], D[k + 1], INITS[k % 2])
        assert got.state.device == dev and torch.cuda.current_device() == 0
        _assert_equal(got, _eager(I[k], D[k], I[k + 1], D[k + 1], INITS[k % 2], dev=dev))
    assert _counts()[:2] == (before[0] + 1, before[1] + 4)
