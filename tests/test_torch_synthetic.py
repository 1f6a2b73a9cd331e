"""The port's room fixtures (phovo_tpu_torch/utils/synthetic.py) against
phovo_tpu's, on the CPU.

render_room is phovo_tpu's numpy code: the same pose matrix gives the same
bits. The trajectories are computed in float64 by the port and through
float32 by phovo_tpu's se3.pose_matrix, so poses agree to POSE_ATOL.
"""

import numpy as np
import pytest

from phovo_tpu.ops.camera import Intrinsics as JIntrinsics
from phovo_tpu.utils import synthetic as jsyn
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.utils import synthetic as tsyn

# phovo_tpu computes each pose in float32 (entries up to ~1.2, an ulp
# 1.2e-7); the largest difference over these trajectories read 9.5e-8
POSE_ATOL = 1e-7
TRAJECTORIES = ("forward", "loop", "smooth", "rotation")
TRAJ_FNS = {"forward": "forward_trajectory", "loop": "loop_trajectory", "smooth": "smooth_trajectory",
            "rotation": "rotation_trajectory"}


def _intr(H, W):
    fx = np.float32(W * 0.8)
    cx, cy = np.float32((W - 1) / 2), np.float32((H - 1) / 2)
    return JIntrinsics(fx, fx, cx, cy), Intrinsics(float(fx), float(fx), float(cx), float(cy))


@pytest.mark.parametrize("traj", TRAJECTORIES)
@pytest.mark.parametrize("seed", [0, 3])
def test_trajectories_match_jax(traj, seed):
    ref = getattr(jsyn, TRAJ_FNS[traj])(48, 1.3, seed)
    got = getattr(tsyn, TRAJ_FNS[traj])(48, 1.3, seed)
    assert len(got) == len(ref) == 48
    for a, b in zip(ref, got):
        assert b.dtype == np.float64 and b.shape == (4, 4)
        np.testing.assert_allclose(b, a, rtol=0, atol=POSE_ATOL)
    # the path moves: a pose matrix per frame, not one repeated
    assert np.abs(got[-1] - got[0]).max() > 0.05


@pytest.mark.parametrize("shape,traj,k", [((96, 128), "forward", 0), ((96, 128), "forward", 40),
                                          ((96, 128), "loop", 20), ((96, 128), "rotation", 30),
                                          ((480, 640), "forward", 33)])
def test_render_room_is_jax_bit_for_bit(shape, traj, k):
    """Both renderers on phovo_tpu's pose matrix: equal bits."""
    jintr, intr = _intr(*shape)
    T = getattr(jsyn, TRAJ_FNS[traj])(48, 1.0, 0)[k]
    I_ref, D_ref = jsyn.render_room(jintr, shape, T)
    I, D = tsyn.render_room(intr, shape, T)
    assert I.dtype == D.dtype == np.float32 and I.shape == D.shape == shape
    np.testing.assert_array_equal(I, I_ref)
    np.testing.assert_array_equal(D, D_ref)
    assert (D > 0).mean() > 0.99 and np.ptp(I) > 0.3  # the room fills the view, textured


@pytest.mark.parametrize("traj", TRAJECTORIES)
def test_make_room_sequence_follows_its_trajectory(traj):
    """Each choice renders its own trajectory: ground truth is the inverse
    of the trajectory's poses (phovo_tpu's to POSE_ATOL), frames are
    render_room of them, timestamps 30 Hz."""
    shape = (48, 64)
    jintr, intr = _intr(*shape)
    I, D, gts, ts = tsyn.make_room_sequence(intr, shape, 5, 1.0, 2, traj)
    poses = getattr(tsyn, TRAJ_FNS[traj])(5, 1.0, 2)
    _, _, jgts, jts = jsyn.make_room_sequence(jintr, shape, 5, 1.0, 2, traj)
    np.testing.assert_array_equal(ts, jts)
    for k in range(5):
        np.testing.assert_array_equal(gts[k], np.linalg.inv(poses[k]))
        np.testing.assert_allclose(gts[k], jgts[k], rtol=0, atol=4 * POSE_ATOL)
        I_k, D_k = tsyn.render_room(intr, shape, poses[k])
        np.testing.assert_array_equal(I[k], I_k)
        np.testing.assert_array_equal(D[k], D_k)


# -- the cluttered scene --------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 4])
def test_default_clutter_is_jax_exactly(seed):
    ref, got = jsyn.default_clutter(seed), tsyn.default_clutter(seed)
    assert len(got) == len(ref) == 6
    for a, b in zip(ref, got):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))


@pytest.mark.parametrize("shape,k", [((60, 80), 0), ((60, 80), 7), ((240, 320), 3)])
def test_render_cluttered_is_jax_bit_for_bit(shape, k):
    """Both renderers on phovo_tpu's pose matrix: equal bits; the scene has
    depth edges and misses (depth 0)."""
    jintr, intr = _intr(*shape)
    T = jsyn.smooth_trajectory(10, 1.0, 0)[k]
    I_ref, D_ref = jsyn.render_cluttered(jintr, shape, T)
    I, D = tsyn.render_cluttered(intr, shape, T)
    assert I.dtype == D.dtype == np.float32 and I.shape == D.shape == shape
    np.testing.assert_array_equal(I, I_ref)
    np.testing.assert_array_equal(D, D_ref)
    assert len(np.unique(np.round(D[D > 0], 1))) > 3  # the plane and boxes at several depths


def test_degrade_frame_is_jax_bit_for_bit():
    jintr, intr = _intr(60, 80)
    I, D = tsyn.render_cluttered(intr, (60, 80), np.eye(4))
    got = tsyn.degrade_frame(I, D, np.random.default_rng(5), 1.05, 0.01)
    ref = jsyn.degrade_frame(I, D, np.random.default_rng(5), 1.05, 0.01)
    for a, b in zip(got, ref):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert (got[1] == 0).sum() > (D == 0).sum()  # holes and edge dropouts


@pytest.mark.parametrize("degrade", [True, False])
def test_make_cluttered_sequence_is_jax_bit_for_bit(monkeypatch, degrade):
    """On phovo_tpu's poses (its smooth_trajectory, float32; the port's own
    is float64, within POSE_ATOL of it: test_trajectories_match_jax) the
    sequence is phovo_tpu's bit for bit: renders, degradations drawn from
    the same seeded generator, ground truth and timestamps."""
    shape = (48, 64)
    jintr, intr = _intr(*shape)
    ref = jsyn.make_cluttered_sequence(jintr, shape, 4, 1.0, 3, degrade)
    monkeypatch.setattr(tsyn, "smooth_trajectory", jsyn.smooth_trajectory)
    got = tsyn.make_cluttered_sequence(intr, shape, 4, 1.0, 3, degrade)
    for a_list, b_list in zip(got[:3], ref[:3]):
        assert len(a_list) == len(b_list) == 4
        for a, b in zip(a_list, b_list):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[3], ref[3])
