"""The object API's pair graph (models/base.PairGraph) on the card: the
ceres object API at 480x640 replays one CUDA graph of K-PREP, the five
K-TR levels and their glue, bit for bit what eager align_autodiff calls
give; a result it returned stays as it was after later pairs; a new
config, new intrinsics or a new frame shape captures once; the counters
count what ran; the blurred presets and the jacfwd mode never capture.

Needs an NVIDIA GPU and nvcc; skipped elsewhere. Run on the card with
    python -m pytest --noconftest -m cuda tests/test_torch_graph_cuda.py
(tests/conftest.py imports jax, which the port's machines need not have)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from phovo_tpu_torch.models import base
from phovo_tpu_torch.models.autodiff import PhotoconsistencyOdometryAutodiff, align_autodiff
from phovo_tpu_torch.ops import fused_batch, prep
from phovo_tpu_torch.ops.camera import TUM_FR1, Intrinsics
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


def _eager(si, sd, ti, td, init, config=CERES5, intr=TUM_FR1, mode="linearizer"):
    dev = torch.device("cuda")
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
