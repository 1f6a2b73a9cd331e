"""The shared-source level (keyframe tracking: one source pack read by
every pair) and the multi-stream level (phovo_tpu's B7) in their plain
versions, held to phovo_tpu's Pallas kernels in interpret mode on the CPU:
fused_gn_level_batch and fused_tr_level_batch with shared_source=True, and
fused_gn_level_multi.

Frames: make_sequence at 24x32 and 48x64 (levels 2 and 1 of the 96x128
camera), the middle frame the keyframe and the others its targets, with
depth zeroed on a 2-pixel border (a pixel at the border warps onto the
bilinear in-bounds edge u = 0, where phovo_tpu's kernel and the port round
to opposite sides: ROADMAP.md section C) and small seeded init states. At
H <= 48 phovo_tpu's banded row window is the whole image, so its kernels
sample what the port samples; their band_masked is asserted 0.

Tolerances: states 5e-5 absolute (both sum float32 pixels, in other
orders; 2.3e-5 apart at worst here, where a pixel is 1/768 of a 24x32
sum), cost and ||J^T r|| 1e-4 relative, iteration and valid counts equal.
Bilinear runs 6 iterations (after 8 from these inits the 'none' costs are
small enough that their float32 noise reaches 2e-4 of them); nearest 2
(nearest Gauss-Newton on the plane does not converge, and after 3
iterations a sample that flips between the two versions' states moves a
cost by 2e-4: tests/test_torch_fused_batch.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phovo_tpu.ops import fused as jfused
from phovo_tpu.ops import pyramid as jpyr
from phovo_tpu.ops.camera import Intrinsics as JIntrinsics
from phovo_tpu.ops.fused_batch import fused_gn_level_batch as jax_gn_batch
from phovo_tpu.ops.fused_batch import fused_tr_level_batch as jax_tr_batch
from phovo_tpu.solvers.trust_region import TROptions as JTROptions
from phovo_tpu_torch.ops import fused as tfused
from phovo_tpu_torch.ops import fused_batch as FB
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.fused import pack_geometry, pack_target
from phovo_tpu_torch.solvers.trust_region import TROptions
from phovo_tpu_torch.utils.synthetic import make_sequence

torch.set_num_threads(1)

CAMERA = Intrinsics(128.0, 128.0, 63.5, 47.5)
SCALE = 0.0625
N_FRAMES = 5
KF = N_FRAMES // 2
TARGETS = [k for k in range(N_FRAMES) if k != KF]
DELTAS = {"none": 0.1, "huber": 0.02, "cauchy": 0.02, "tukey": 0.1}
TESTS_OFF = dict(function_tolerance=1e-9, gradient_tolerance=1e-12, parameter_tolerance=1e-10)
STATE_ATOL = 5e-5


def _frames(level):
    """(intrinsics, I, D, gx, gy, init) of one level's frames, numpy."""
    intr = CAMERA.at_level(level)
    shape = (96 >> level, 128 >> level)
    I, D, _, _ = make_sequence(intr, shape, N_FRAMES, motion_scale=2.0, seed=level)
    I, D = np.stack(I), np.stack(D)
    D[:, :2] = D[:, -2:] = 0.0
    D[:, :, :2] = D[:, :, -2:] = 0.0
    gx, gy = jpyr.build_gradient_pyramid([jnp.asarray(I)], (SCALE,))
    init = (np.random.default_rng(level).standard_normal((len(TARGETS), 6)) * 1e-3).astype(np.float32)
    return intr, I, D, np.asarray(gx[0]), np.asarray(gy[0]), init


def _jax_packs(intr, I, D, gx, gy, esm):
    H, W = I.shape[1:]
    jintr = JIntrinsics(*(np.float32(v) for v in intr))
    NP, _ = jfused._pick_tile_pixels(H, W)
    i0 = jfused._pad_flat(jnp.asarray(I[KF]).reshape(1, H * W), NP)
    sg = (jnp.asarray(gx[KF]), jnp.asarray(gy[KF])) if esm else None
    geom = jfused.pack_geometry(jnp.asarray(D[KF]), jintr, 0.3, 5.0, NP, sg)
    t_all = jnp.stack([
        jfused.pack_target_colmajor(jnp.asarray(I[k]), jnp.asarray(gx[k]), jnp.asarray(gy[k])) for k in TARGETS
    ])
    return jintr, i0, geom, t_all


def _port_packs(intr, I, D, gx, gy, esm):
    It, Dt, gxt, gyt = (torch.from_numpy(x) for x in (I, D, gx, gy))
    sg = (gxt[KF:KF + 1], gyt[KF:KF + 1]) if esm else None
    return (
        It[KF].reshape(1, -1).contiguous(),
        pack_geometry(Dt[KF:KF + 1], intr, 0.3, 5.0, sg).contiguous(),
        pack_target(It, gxt, gyt)[TARGETS].contiguous(),
    )


def _assert_match(port, state, its, nvalid, cost, gnorm=None):
    np.testing.assert_allclose(port.state.numpy(), np.asarray(state), rtol=0, atol=STATE_ATOL)
    np.testing.assert_array_equal(port.iterations.numpy(), np.asarray(its))
    np.testing.assert_array_equal(port.num_valid.numpy(), np.asarray(nvalid))
    np.testing.assert_allclose(port.cost.numpy(), np.asarray(cost), rtol=1e-4)
    if gnorm is not None:
        np.testing.assert_allclose(port.gradient_norm.numpy(), np.asarray(gnorm), rtol=1e-4)


GN_CASES = [
    (2, "bilinear", 6, "none", False),
    (2, "bilinear", 6, "huber", False),
    (2, "bilinear", 6, "tukey", False),
    (2, "bilinear", 6, "none", True),
    (2, "nearest", 2, "huber", False),
    (2, "nearest", 2, "cauchy", True),
    (1, "bilinear", 6, "none", False),
    (1, "nearest", 2, "tukey", False),
]


@pytest.mark.parametrize("level,sampling,its,loss,esm", GN_CASES)
def test_shared_gn_level_matches_jax(level, sampling, its, loss, esm):
    intr, I, D, gx, gy, init = _frames(level)
    H, W = I.shape[1:]
    jintr, *jpacks = _jax_packs(intr, I, D, gx, gy, esm)
    ref = jax_gn_batch(
        *jpacks, jintr, jnp.asarray(init), 0.3, 5.0, its, 0.0, 1.0, H=H, W=W, sampling=sampling,
        interpret=True, mix_mode="f32", robust_loss=loss, robust_delta=DELTAS[loss], esm=esm,
        shared_source=True,
    )
    state, iters, gnorm, cost, nvalid, masked = (np.asarray(x) for x in ref)
    assert np.all(masked == 0)
    port = FB.fused_gn_level_batch(
        *_port_packs(intr, I, D, gx, gy, esm), intr, torch.from_numpy(init), its, 0.0, 1.0, H=H, W=W,
        sampling=sampling, robust_loss=loss, robust_delta=DELTAS[loss], esm=esm,
    )
    _assert_match(port, state, iters, nvalid, cost, gnorm)


@pytest.mark.parametrize("level,its,loss", [(2, 6, "none"), (2, 4, "huber"), (2, 4, "tukey"), (1, 4, "none")])
def test_shared_tr_level_matches_jax(level, its, loss):
    """The trust-region level with a shared source, bilinear, the
    stopping tests off: the whole budget."""
    intr, I, D, gx, gy, init = _frames(level)
    H, W = I.shape[1:]
    jintr, *jpacks = _jax_packs(intr, I, D, gx, gy, False)
    ref = jax_tr_batch(
        *jpacks, jintr, jnp.asarray(init), 0.3, 5.0, JTROptions(its, **TESTS_OFF), H=H, W=W,
        sampling="bilinear", interpret=True, mix_mode="f32", robust_loss=loss, robust_delta=DELTAS[loss],
        shared_source=True,
    )
    state, iters, cost, gnorm, radius, nvalid, masked = (np.asarray(x) for x in ref)
    assert np.all(masked == 0)
    port = FB.fused_tr_level_batch(
        *_port_packs(intr, I, D, gx, gy, False), intr, torch.from_numpy(init), TROptions(its, **TESTS_OFF),
        H=H, W=W, robust_loss=loss, robust_delta=DELTAS[loss],
    )
    _assert_match(port, state, iters, nvalid, cost)
    if its <= 4:  # the radius over short budgets (tests/test_torch_trust_region.py)
        np.testing.assert_allclose(port.radius.numpy(), radius, rtol=1e-4)


@pytest.mark.parametrize("level,sampling,its,loss,esm", [
    (2, "bilinear", 6, "none", False), (2, "nearest", 2, "huber", True), (1, "bilinear", 6, "tukey", False),
])
def test_multi_level_matches_jax(level, sampling, its, loss, esm):
    """fused_gn_level_multi (B7) on the CPU, its plain version, against
    phovo_tpu's multi-stream kernel in interpret mode: S streams, each
    frame k to frame k + 1."""
    intr, I, D, gx, gy, _ = _frames(level)
    H, W = I.shape[1:]
    S = N_FRAMES - 1
    init = (np.random.default_rng(7).standard_normal((S, 6)) * 1e-3).astype(np.float32)
    jintr = JIntrinsics(*(np.float32(v) for v in intr))
    tgt = np.concatenate([I[1:], gx[1:], gy[1:]], axis=1)  # (S, 3H, W)
    sg = (gx[:-1], gy[:-1]) if esm else None
    ref = jfused.fused_gn_level_multi(
        jnp.asarray(I[:-1]), jnp.asarray(D[:-1]), jnp.asarray(tgt), jintr, jnp.asarray(init), 0.3, 5.0,
        its, 0.0, 1.0, sampling, interpret=True, robust_loss=loss, robust_delta=DELTAS[loss],
        source_grads=None if sg is None else tuple(jnp.asarray(x) for x in sg),
    )
    state, iters, gnorm, cost, nvalid, masked = (np.asarray(x) for x in ref)
    assert np.all(masked == 0)
    before = (FB.LAUNCHES, tfused.MULTI_LAUNCHES)
    args = (torch.from_numpy(I[:-1]), torch.from_numpy(D[:-1]), torch.from_numpy(tgt), intr,
            torch.from_numpy(init), 0.3, 5.0, its, 0.0, 1.0, sampling, loss, DELTAS[loss],
            None if sg is None else tuple(torch.from_numpy(x) for x in sg))
    port = tfused.fused_gn_level_multi(*args)
    assert (FB.LAUNCHES, tfused.MULTI_LAUNCHES) == before  # CPU tensors: the plain version
    for a, b in zip(port, tfused.fused_gn_level_multi_reference(*args)):
        assert torch.equal(a, b)
    _assert_match(port, state, iters, nvalid, cost, gnorm)


def test_multi_level_refuses_tdist_and_other_devices():
    intr, I, D, gx, gy, init = _frames(2)
    tgt = torch.from_numpy(np.concatenate([I[1:], gx[1:], gy[1:]], axis=1))
    args = (torch.from_numpy(I[:-1]), torch.from_numpy(D[:-1]), tgt, intr, torch.from_numpy(init), 0.3, 5.0, 2,
            0.0, 1.0)
    for fn in (tfused.fused_gn_level_multi, tfused.fused_gn_level_multi_reference):
        with pytest.raises(ValueError, match="tdist"):
            fn(*args, "nearest", "tdist")
    with pytest.raises(ValueError, match="no level kernel for device"):
        tfused.fused_gn_level_multi(*(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args))
