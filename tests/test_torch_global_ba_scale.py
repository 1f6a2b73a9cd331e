"""The global photometric BA at the size of chip_smoke.py's timing problem
(phase 7g): 64 room keyframes on the forward sweep, grid 8, covisibility
6, so P = 4,096 landmarks and K = 24,576 observations, against phovo_tpu
on the CPU. The card's problem is at 480x640; here the same keyframe,
landmark and observation counts are built at 120x160 and 240x320 (the
intrinsics scaled), so the covisibility table and the Schur machinery run
at full scale while the images stay small.

Held, each tolerance beside the reading that set it:
  * the builders' arrays equal, bit for bit (the same numpy code);
  * one LM iteration at damping 1.0, dense and sparse: the port's states
    within 1e-6 of phovo_tpu's (7.5e-8 measured at 120x160, 1.5e-7 at
    240x320), and the port's dense within 1e-6 of its sparse (6.0e-8
    measured at both sizes). Later iterations drift apart through the
    landmarks: their blocks differ by
    ~1e-5 relative (the Jacobians' cos and sin round apart by an ulp) and
    the damped V blocks have condition numbers of thousands, so one step
    moves the worst landmark 2.8e-4 apart, and the poses follow;
  * three iterations at the production damping 1e-4, by outcome: both
    packages lower the cost at least 2x (4.5-7.6x measured), and the
    port's largest state error lies within a factor of 2 of phovo_tpu's
    (0.72-1.12x measured). Both packages end with a larger largest error
    than the start's 1.2e-2 (phovo_tpu 1.3e-2 to 2.0e-2) while the cost
    falls: that is the reference's behaviour on this problem, which the
    test prints (pytest -s).
"""

import numpy as np
import pytest
import torch

import phovo_tpu.parallel.photometric_ba as JP
from phovo_tpu.ops.camera import Intrinsics as JIntrinsics
from phovo_tpu_torch.ops import se3
from phovo_tpu_torch.ops.camera import TUM_FR1, Intrinsics
from phovo_tpu_torch.parallel import photometric_ba as TP
from phovo_tpu_torch.utils.synthetic import forward_trajectory, render_room

torch.set_num_threads(1)

N_KF, GRID, COVIS = 64, 8, 6
ROBUST = dict(robust_delta=0.1, robust_z_delta=0.02)
ONE_STEP_ATOL = 1e-6


def _problems(scale):
    """Both packages' global problem over N_KF room keyframes at 480x640 /
    scale, started as chip_smoke.py's phase 7g starts it (5 mm and 2.5
    mrad of noise, seed 0); and the ground-truth states."""
    H, W = 480 // scale, 640 // scale

    def px(c):
        return (c + 0.5) / scale - 0.5

    jintr = JIntrinsics(*(np.float32(v) for v in (TUM_FR1.fx / scale, TUM_FR1.fy / scale, px(TUM_FR1.cx),
                                                  px(TUM_FR1.cy))))
    intr = Intrinsics(*(float(v) for v in jintr))
    poses = forward_trajectory(N_KF)
    frames = [render_room(intr, (H, W), T) for T in poses]
    I, D = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
    gt = se3.matrix_to_state_np(np.linalg.inv(np.stack(poses))).astype(np.float32)
    rng = np.random.default_rng(0)
    start = gt.copy()
    start[1:, :3] += rng.normal(0.0, 0.005, (N_KF - 1, 3)).astype(np.float32)
    start[1:, 3:] += rng.normal(0.0, 0.0025, (N_KF - 1, 3)).astype(np.float32)
    jp = JP.build_photometric_global(I, D, start, jintr, grid=GRID, max_covis=COVIS, occ_gate=0.3)
    tp = TP.build_photometric_global(I, D, start, intr, grid=GRID, max_covis=COVIS, occ_gate=0.3, device="cpu")
    return jp, tp, jintr, intr, gt


@pytest.mark.parametrize("scale", [4, 2])
def test_global_problem_at_timing_size_matches_jax(scale):
    jp, tp, jintr, intr, gt = _problems(scale)
    assert tp.points.shape[0] == 4096 and tp.obs_pose.shape[0] == 24576
    for name, a, b in zip(jp._fields, jp, tp):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=name)

    states = {}
    for schur in ("dense", "sparse"):
        kw = dict(iterations=1, damping=1.0, schur=schur, **ROBUST)
        ref = np.asarray(JP.optimize_photometric_bundle(jp, jintr, **kw)[0])
        states[schur] = TP.optimize_photometric_bundle(tp, intr, **kw)[0].numpy()
        assert np.abs(ref - np.asarray(jp.pose_states)).max() > 1e-4  # the step does something
        np.testing.assert_allclose(states[schur], ref, rtol=0, atol=ONE_STEP_ATOL, err_msg=schur)
    np.testing.assert_allclose(states["dense"], states["sparse"], rtol=0, atol=ONE_STEP_ATOL)

    def err(s):
        return float(np.abs(np.asarray(s) - gt).max())

    cost0 = float(TP.optimize_photometric_bundle(tp, intr, iterations=0, **ROBUST)[2])
    line = [f"{480 // scale}x{640 // scale}: start cost {cost0:.3f}, largest state error {err(tp.pose_states):.4e}"]
    for schur in ("dense", "sparse"):
        kw = dict(iterations=3, damping=1e-4, schur=schur, **ROBUST)
        ref = JP.optimize_photometric_bundle(jp, jintr, **kw)
        got = TP.optimize_photometric_bundle(tp, intr, **kw)
        line.append(f"{schur} at 1e-4: phovo_tpu cost {float(ref[2]):.3f} error {err(ref[0]):.4e}, port cost "
                    f"{float(got[2]):.3f} error {err(got[0]):.4e}")
        assert float(ref[2]) < 0.5 * cost0 and float(got[2]) < 0.5 * cost0, line
        assert 0.5 < err(got[0]) / err(ref[0]) < 2.0, line
    print("; ".join(line))
