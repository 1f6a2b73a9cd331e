"""The ceres backend's jacobian_mode='jacfwd' (torch.func.jacfwd over
ops/residuals.residual_vector, the exact derivative of the bilinear
interpolant) against phovo_tpu's jax.jacfwd mode, on the CPU.

  * residual_vector and residual_valid_count against phovo_tpu's at 1e-5;
  * one pair at tests/test_autodiff_modes.py's CFG and small_pair: states
    within 1e-5, per-level iterations and valid counts equal; jacfwd and
    the linearizer mode within 5e-3 of each other and of the truth
    (tests/test_autodiff_modes.py:25), and the valid counts real (:41);
  * every entry point in jacfwd mode (align_autodiff, the zero-init and
    the warm sequences, which run pair after pair, the chunked entry and
    the object API) against phovo_tpu's on a 3-frame 60x80 sequence with
    a depth-less border of 4 pixels (from zero, a border pixel warps onto
    the bilinear edge u = 0, where the two packages round to opposite
    sides): states within 1e-5, iterations and valid counts equal;
  * KeyframeVisualOdometry.run_chunked refuses a jacfwd odometry with
    RuntimeError, as phovo_tpu's does; run() tracks with it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phovo_tpu.models import autodiff as jad
from phovo_tpu.ops import residuals as jres
from phovo_tpu.ops.camera import Intrinsics as JIntrinsics
from phovo_tpu.utils.config import PhovoConfig as JConfig
from phovo_tpu_torch.datasets.tum import RGBDFrame
from phovo_tpu_torch.models import autodiff as tad
from phovo_tpu_torch.models.keyframe import KeyframeVisualOdometry
from phovo_tpu_torch.ops import residuals as tres
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.utils.config import PhovoConfig
from phovo_tpu_torch.utils.synthetic import make_sequence

torch.set_num_threads(1)

STATE_ATOL = 1e-5
# tests/test_autodiff_modes.py's CFG
CFG = dict(
    num_levels=2, blur_filter_sizes=(0, 0), gradient_scales=(0.0625, 0.0625), max_iterations=(25, 25),
    function_tolerances=(1e-9, 1e-9), gradient_tolerances=(1e-12, 1e-12), parameter_tolerances=(1e-10, 1e-10),
    initial_trust_region_radii=(1e4, 1e4), max_trust_region_radii=(1e8, 1e8), min_trust_region_radii=(1e-32, 1e-32),
    min_relative_decreases=(1e-3, 1e-3), sampling="bilinear",
)
SEQ_CFG = dict(CFG, max_iterations=(6, 6))
INTR = Intrinsics(80.0, 80.0, 39.5, 29.5)
JINTR = JIntrinsics(*(np.float32(v) for v in INTR))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(res):
    return [np.asarray(x) for x in res]


@pytest.fixture(scope="module")
def seq():
    """3 frames at 60x80 with a depth-less 4-pixel border."""
    I, D, _, _ = make_sequence(INTR, (60, 80), 3, seed=2)
    D = np.stack(D)
    D[:, :4], D[:, -4:], D[:, :, :4], D[:, :, -4:] = 0.0, 0.0, 0.0, 0.0
    return np.stack(I), D


@pytest.fixture(scope="module")
def jax_seq(seq):
    """phovo_tpu's jacfwd sequences over `seq`: (zero init, warm)."""
    I, D = map(jnp.asarray, seq)
    cfg = JConfig(**SEQ_CFG)
    return tuple(_np(jad.align_sequence_autodiff(I, D, JINTR, cfg, "jacfwd", warm)) for warm in (False, True))


def _assert_matches(res, ref):
    """res (port AlignmentResult) against ref (phovo_tpu's, as arrays)."""
    np.testing.assert_allclose(res.state.numpy(), ref[0], rtol=0, atol=STATE_ATOL)
    np.testing.assert_array_equal(res.iterations.numpy(), ref[1])
    np.testing.assert_array_equal(res.num_valid.numpy(), ref[4])
    assert (ref[4] > 0).all() and (ref[1] > 0).all()


def test_residual_vector_and_valid_count_match_jax(seq):
    I, D = seq
    state = np.array([0.01, -0.006, 0.012, 0.004, -0.003, 0.005], np.float32)
    r = tres.residual_vector(_t(state), _t(I[0]), _t(D[0]), _t(I[1]), INTR)
    jr = np.asarray(jres.residual_vector(jnp.asarray(state), jnp.asarray(I[0]), jnp.asarray(D[0]),
                                         jnp.asarray(I[1]), JINTR))
    assert r.shape == (60 * 80,)
    np.testing.assert_allclose(r.numpy(), jr, rtol=0, atol=1e-5)
    nv = tres.residual_valid_count(_t(state), _t(D[0]), _t(I[1]), INTR)
    jnv = float(jres.residual_valid_count(jnp.asarray(state), jnp.asarray(D[0]), jnp.asarray(I[1]), JINTR))
    assert float(nv) == jnv == float((r != 0).sum()) and jnv > 0.5 * 52 * 72
    # torch.func.jacfwd runs through it: the Jacobian of the valid rows
    J = torch.func.jacfwd(lambda s: tres.residual_vector(s, _t(I[0]), _t(D[0]), _t(I[1]), INTR))(_t(state))
    assert J.shape == (60 * 80, 6) and bool(torch.isfinite(J).all()) and float(J.abs().sum()) > 0


def test_jacfwd_matches_jax_jacfwd(intr, small_pair):
    I0, D0, I1, D1, gt = small_pair
    tintr = Intrinsics(*(float(v) for v in intr))
    ref = _np(jad.align_autodiff(*map(jnp.asarray, (I0, D0, I1, D1)), intr, jnp.zeros(6), JConfig(**CFG), "jacfwd"))
    res = tad.align_autodiff(*map(_t, (I0, D0, I1, D1)), tintr, torch.zeros(6), PhovoConfig(**CFG), "jacfwd")
    _assert_matches(res, ref)
    # the exact derivative of the interpolant and the warped-point gradient
    # model recover the same pose
    lin = tad.align_autodiff(*map(_t, (I0, D0, I1, D1)), tintr, torch.zeros(6), PhovoConfig(**CFG), "linearizer")
    np.testing.assert_allclose(res.state.numpy(), lin.state.numpy(), rtol=0, atol=5e-3)
    np.testing.assert_allclose(res.state.numpy(), gt, rtol=0, atol=5e-3)


def test_jacfwd_reports_num_valid(intr, small_pair):
    I0, D0, I1, D1, _ = small_pair
    cfg = PhovoConfig(num_levels=2, blur_filter_sizes=(0, 0), gradient_scales=(0.0625,) * 2, max_iterations=(2, 2),
                      lambda_steps=(1.0, 1.0), min_gradient_norms=(1e-10,) * 2, sampling="bilinear")
    res = tad.align_autodiff(*map(_t, (I0, D0, I1, D1)), Intrinsics(*(float(v) for v in intr)), torch.zeros(6), cfg,
                             "jacfwd")
    nv = res.num_valid.numpy()
    assert nv[0] > 0.5 * I0.size and nv[1] > 0.5 * I0.size / 4


ENTRIES = ["align_autodiff", "sequence", "sequence-warm", "chunk", "object-api"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_jacfwd_entry_points_match_jax(seq, jax_seq, entry):
    """Each entry point in jacfwd mode: a sequence runs pair after pair
    (zero init, or warm from the last pair), as phovo_tpu's scan does."""
    I, D = map(_t, seq)
    cfg = PhovoConfig(**SEQ_CFG)
    zero, warm = jax_seq
    if entry == "align_autodiff":
        res, ref = tad.align_autodiff(I[0], D[0], I[1], D[1], INTR, torch.zeros(6), cfg, "jacfwd"), [x[0] for x in zero]
    elif entry == "object-api":
        vo = tad.PhotoconsistencyOdometryAutodiff(cfg, "jacfwd", device="cpu")
        vo.set_intrinsic_matrix(INTR.matrix())
        vo.set_source_frame(seq[0][1], seq[1][1])
        vo.set_target_frame(seq[0][2], seq[1][2])
        vo.set_initial_state_vector(np.zeros(6))
        res, ref = vo.optimize(), [x[1] for x in zero]
    elif entry == "chunk":
        res, ci, cd = tad.align_sequence_chunk_autodiff(I[0], D[0], I[1:], D[1:], INTR, cfg, "jacfwd")
        assert torch.equal(ci, I[-1]) and torch.equal(cd, D[-1])
        ref = zero
    else:
        res = tad.align_sequence_autodiff(I, D, INTR, cfg, "jacfwd", warm_start=entry == "sequence-warm")
        ref = warm if entry == "sequence-warm" else zero
    _assert_matches(res, ref)


def test_keyframe_run_chunked_refuses_jacfwd_and_run_tracks(seq):
    I, D = seq
    vo = tad.PhotoconsistencyOdometryAutodiff(PhovoConfig(**dict(SEQ_CFG, max_iterations=(2, 2))), "jacfwd",
                                              device="cpu")
    vo.set_intrinsic_matrix(INTR.matrix())
    frames = [RGBDFrame(timestamp=float(k), depth_timestamp=float(k), intensity=I[k], depth=D[k]) for k in range(3)]
    with pytest.raises(RuntimeError, match="use run"):
        list(KeyframeVisualOdometry(vo).run_chunked(iter(frames), chunk=2))
    tracked = list(KeyframeVisualOdometry(vo).run(iter(frames)))
    assert len(tracked) == 2 and all(np.isfinite(t.pose).all() for t in tracked)
