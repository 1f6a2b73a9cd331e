"""Public names of ported modules against phovo_tpu's, on the CPU:
Intrinsics.matrix(), AlignmentResult.transform() and its band_masked
default, the se3 tensor forms (rotation_zyx, rotation_to_quaternion,
quaternion_to_rotation) and the warps (warp_coordinates, gather_warp, and
forward_warp, the reference's warpImage scatter, bit for bit where
several source pixels land on one target pixel).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from phovo_tpu.models.base import AlignmentResult as JResult
from phovo_tpu.ops import se3 as jse3
from phovo_tpu.ops import warp as jwarp
from phovo_tpu.ops.camera import TUM_FR1 as J_FR1
from phovo_tpu.ops.camera import Intrinsics as JIntrinsics
from phovo_tpu_torch.models.base import AlignmentResult
from phovo_tpu_torch.ops import se3, warp
from phovo_tpu_torch.ops.camera import NAMED_INTRINSICS, Intrinsics
from phovo_tpu_torch.utils.synthetic import make_pair

# tests/test_se3.py's states
STATES = [
    np.zeros(6, np.float32),
    np.array([0.1, -0.2, 0.3, 0.4, -0.5, 0.6], np.float32),
    np.array([1.0, 2.0, -3.0, -2.5, 1.2, 3.0], np.float32),
]
INTR = Intrinsics(80.0, 80.0, 39.5, 29.5)
JINTR = JIntrinsics(*(np.float32(v) for v in INTR))
SHAPE = (60, 80)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", sorted(NAMED_INTRINSICS))
def test_intrinsics_matrix_is_jax_exactly(name):
    from phovo_tpu.ops.camera import NAMED_INTRINSICS as JNAMED

    K = NAMED_INTRINSICS[name].matrix()
    assert K.dtype == torch.float32 and K.shape == (3, 3)
    np.testing.assert_array_equal(K.numpy(), np.asarray(JNAMED[name].matrix()))
    assert Intrinsics.from_matrix(K) == NAMED_INTRINSICS[name]


def test_alignment_result_transform_and_band_masked_default():
    state = torch.from_numpy(STATES[1])
    res = AlignmentResult(state, torch.zeros(2, dtype=torch.int32), torch.zeros(2), torch.zeros(2), torch.zeros(2))
    jres = JResult(jnp.asarray(STATES[1]), *(jnp.zeros(2),) * 4)
    assert res.band_masked == 0.0 == jres.band_masked
    assert torch.equal(res.transform(), se3.pose_matrix(state))
    np.testing.assert_allclose(res.transform().numpy(), np.asarray(jres.transform()), rtol=0, atol=1e-6)


@pytest.mark.parametrize("state", STATES)
def test_rotation_zyx_matches_jax(state):
    R = se3.rotation_zyx(*_t(state[3:]).unbind(-1))
    np.testing.assert_allclose(R.numpy(), np.asarray(jse3.rotation_zyx(*jnp.asarray(state[3:]))), rtol=0, atol=1e-6)
    assert torch.equal(R, se3.pose_matrix(_t(state))[:3, :3])


def test_se3_tensor_forms_batched_match_jax():
    """tests/test_se3.py:125-134's batch: 16 seeded states, the tensor
    forms against phovo_tpu's and the float64 twins."""
    rng = np.random.default_rng(11)
    states = rng.uniform(-1.0, 1.0, (16, 6)).astype(np.float32)
    R = se3.rotation_zyx(*_t(states[:, 3:]).unbind(-1))
    jR = np.asarray(jse3.rotation_zyx(*jnp.moveaxis(jnp.asarray(states[:, 3:]), -1, 0)))
    assert R.shape == (16, 3, 3)
    np.testing.assert_allclose(R.numpy(), jR, rtol=0, atol=1e-6)
    q = se3.rotation_to_quaternion(R)
    np.testing.assert_allclose(q.numpy(), np.asarray(jse3.rotation_to_quaternion(jnp.asarray(jR))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(q.numpy(), se3.rotation_to_quaternion_np(R.numpy()), rtol=0, atol=1e-6)
    R2 = se3.quaternion_to_rotation(q)
    np.testing.assert_allclose(R2.numpy(), np.asarray(jse3.quaternion_to_rotation(jnp.asarray(q.numpy()))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(R2.numpy(), R.numpy(), rtol=0, atol=1e-6)
    # a (2, 8) batch keeps its leading dims
    assert se3.rotation_to_quaternion(R.reshape(2, 8, 3, 3)).shape == (2, 8, 4)


@pytest.mark.parametrize("state", STATES)
def test_quaternion_round_trip_matches_jax_and_scipy(state):
    R = se3.pose_matrix(_t(state))[:3, :3]
    q = se3.rotation_to_quaternion(R)
    q_sp = Rotation.from_matrix(R.double().numpy()).as_quat()
    q_sp = -q_sp if q_sp[3] < 0 else q_sp
    np.testing.assert_allclose(q.numpy(), q_sp, atol=1e-5)
    np.testing.assert_allclose(q.numpy(), np.asarray(jse3.rotation_to_quaternion(jnp.asarray(R.numpy()))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(se3.quaternion_to_rotation(q).numpy(), R.numpy(), atol=1e-5)


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_quaternion_negative_trace_branches(axis):
    """Rotations near pi take the non-trace-dominant candidates."""
    R = Rotation.from_euler(axis, np.pi - 1e-3).as_matrix().astype(np.float32)
    q = se3.rotation_to_quaternion(_t(R))
    np.testing.assert_allclose(q.numpy(), np.asarray(jse3.rotation_to_quaternion(jnp.asarray(R))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(se3.quaternion_to_rotation(q).numpy(), R, atol=1e-5)


def _pair(state):
    return make_pair(INTR, SHAPE, np.asarray(state, np.float32))


@pytest.mark.parametrize("level", [0, 1])
def test_warp_coordinates_match_jax(level):
    I0, D0, I1, D1, gt = _pair([0.02, -0.015, 0.01, 0.008, -0.006, 0.01])
    col, row, z = warp.warp_coordinates(_t(D0), _t(gt), INTR.at_level(level))
    jc, jr, jz = (np.asarray(a) for a in jwarp.warp_coordinates(jnp.asarray(D0), jnp.asarray(gt),
                                                                 JINTR.at_level(level)))
    np.testing.assert_allclose(col.numpy(), jc, rtol=0, atol=1e-4)
    np.testing.assert_allclose(row.numpy(), jr, rtol=0, atol=1e-4)
    np.testing.assert_allclose(z.numpy(), jz, rtol=0, atol=1e-6)


@pytest.mark.parametrize("bilinear", [True, False])
def test_gather_warp_matches_jax(bilinear):
    I0, D0, I1, D1, gt = _pair([0.02, -0.015, 0.01, 0.008, -0.006, 0.01])
    D0 = D0.copy()
    D0[20:30, 30:40] = 0.0  # a hole: invalid whatever the warp
    vals, valid = warp.gather_warp(_t(I1), _t(D0), _t(gt), INTR, bilinear=bilinear)
    jv, jvalid = (np.asarray(a) for a in jwarp.gather_warp(jnp.asarray(I1), jnp.asarray(D0), jnp.asarray(gt), JINTR,
                                                           bilinear=bilinear))
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_allclose(vals.numpy(), jv, rtol=0, atol=1e-5)
    assert 0.5 < valid.float().mean() < 1.0
    # photoconsistency: the target warped back through the truth is the source
    assert np.median(np.abs(vals.numpy() - I0)[valid.numpy()]) < 5e-3


# forward motions of 5-10 cm: the target is closer to the plane, so several
# source pixels truncate to one target pixel
@pytest.mark.parametrize("state", [[0.0, 0.0, 0.05, 0.0, 0.0, 0.0], [0.01, -0.02, 0.08, 0.01, -0.02, 0.015],
                                   [-0.02, 0.01, 0.1, -0.015, 0.01, -0.02]])
def test_forward_warp_is_jax_bit_for_bit_with_collisions(state):
    I0, D0, _, _, _ = _pair(np.zeros(6))
    D0 = D0.copy()
    D0[:, :3] = 0.0  # invalid source pixels never write
    out = warp.forward_warp(_t(I0), _t(D0), _t(np.asarray(state, np.float32)), INTR)
    ref = np.asarray(jwarp.forward_warp(jnp.asarray(I0), jnp.asarray(D0), jnp.asarray(state, jnp.float32), JINTR))
    np.testing.assert_array_equal(out.numpy(), ref)
    # the collisions exist: fewer distinct target pixels than writing sources
    col, row, _ = warp.warp_coordinates(_t(D0), _t(np.asarray(state, np.float32)), INTR)
    ci, ri = col.to(torch.int32), row.to(torch.int32)
    writes = (_t(D0) > 0) & (ri >= 0) & (ri < SHAPE[0]) & (ci >= 0) & (ci < SHAPE[1])
    targets = (ri * SHAPE[1] + ci)[writes]
    assert int(writes.sum()) - len(torch.unique(targets)) > 50
    assert (out.numpy() == 0).mean() > 0.02  # and holes where nothing lands


def test_forward_warp_truncates_toward_zero_and_drops_far_points():
    """A column in (-1, 0) truncates to 0 and lands in the image; a point
    projected far outside (z = 0 divides by 1e-12: |column| past int32)
    lands nowhere, on both packages."""
    H, W = 4, 6
    intr = Intrinsics(1.0, 1.0, 0.0, 0.0)
    D = np.ones((H, W), np.float32)
    I = np.arange(1, H * W + 1, dtype=np.float32).reshape(H, W)
    for state in ([-0.5, 0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, -1.0, 0.0, 0.0, 0.0]):
        s = np.asarray(state, np.float32)
        out = warp.forward_warp(_t(I), _t(D), _t(s), intr)
        ref = np.asarray(jwarp.forward_warp(jnp.asarray(I), jnp.asarray(D), jnp.asarray(s), JIntrinsics(
            *(np.float32(v) for v in intr))))
        np.testing.assert_array_equal(out.numpy(), ref)
        if state[2] == -1.0:  # only column 0 (x = 0) stays in the image
            assert (out.numpy()[:, 1:] == 0).all() and (out.numpy()[1:, 0] == 0).all()
    shifted = warp.forward_warp(_t(I), _t(D), _t(np.asarray([-0.5, 0, 0, 0, 0, 0], np.float32)), intr)
    assert float(shifted[0, 0]) == float(I[0, 1])  # column 1 - 0.5 -> 0; column 0 - 0.5 = -0.5 -> 0 as well, later wins
