"""The robust, Student-t and ESM variants of the port's level kernels, their
plain versions held to phovo_tpu on the CPU, and the robust aligner's
behaviour on an occluded pair.

References, on the same numpy frames (a 4-frame make_sequence chain at
30x40 whose targets carry a bright occluder, so the robust weights bite):
  * the IRLS weights and the Student-t scale step of phovo_tpu/ops/robust.py;
  * phovo_tpu's batched Gauss-Newton kernel fused_gn_level_batch (B1) in
    interpret mode, for the plain K-GN twin with each loss and ESM;
  * phovo_tpu's per-pair kernel fused_gn_level (B3) in interpret mode, for
    the Student-t level with its burn-in;
  * phovo_tpu's one-linearization kernel fused_normal_equations_pallas (B6)
    in interpret mode, for the plain K-LIN Gram;
  * phovo_tpu's batched trust-region kernel fused_tr_level_batch (B2) in
    interpret mode, for the plain K-TR with huber, cauchy and tukey.
At 30x40 the TPU kernels' banded row window holds every row, so they sample
what the port samples (band_masked is asserted 0).

Tolerances: states 2e-4 absolute, cost 1e-4 relative, iterations and
valid counts equal (tests/test_torch_fused_batch.py's levels); the Gram
1e-5 of its largest entry; weights 1e-6 relative. Nearest sampling runs 3
iterations, bilinear up to 8 (see tests/test_torch_fused_batch.py). Init
states are small seeded perturbations of zero (the bilinear edge u = 0,
tests/test_torch_fused_batch.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phovo_tpu.ops import fused as jfused
from phovo_tpu.ops import robust as jrobust
from phovo_tpu.ops.camera import Intrinsics as JIntrinsics
from phovo_tpu.ops.fused_batch import fused_gn_level_batch as jax_gn_batch
from phovo_tpu.ops.fused_batch import fused_tr_level_batch as jax_tr_batch
from phovo_tpu.solvers.trust_region import TROptions as JTROptions
from phovo_tpu_torch.models.analytic import PhotoconsistencyOdometryAnalytic
from phovo_tpu_torch.ops import fused as tfused
from phovo_tpu_torch.ops import fused_batch as FB
from phovo_tpu_torch.ops import pyramid as tpyr
from phovo_tpu_torch.ops import robust as trobust
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.solvers.trust_region import TROptions
from phovo_tpu_torch.utils.config import PhovoConfig
from phovo_tpu_torch.utils.synthetic import make_pair, make_sequence

torch.set_num_threads(1)

SHAPE = (30, 40)
B = 3
SCALE = 0.0625
INTR = Intrinsics(40.0, 40.0, 19.5, 14.5)
JINTR = JIntrinsics(*(np.float32(v) for v in INTR))
# tests/test_robust.py:117-118's scales, and tdist's seed
DELTAS = {"none": 0.1, "huber": 0.02, "cauchy": 0.02, "tukey": 0.1, "tdist": 0.1}


@pytest.fixture(scope="module")
def frames():
    """B+1 frames, the targets occluded; per frame its image, depth, Scharr
    gradients and target pack; seeded init states."""
    I, D, _, _ = make_sequence(INTR, SHAPE, B + 1, motion_scale=2.0, seed=3)
    I, D = np.stack(I), np.stack(D)
    I[1:, 4:11, 6:20] = 0.95  # a smooth bright patch in every target
    It, Dt = torch.from_numpy(I), torch.from_numpy(D)
    gx, gy = tpyr.scharr(It, "x", SCALE), tpyr.scharr(It, "y", SCALE)
    init = (np.random.default_rng(5).standard_normal((B, 6)) * 1e-3).astype(np.float32)
    return dict(I=It, D=Dt, gx=gx, gy=gy, t_all=tfused.pack_target(It, gx, gy), init=init)


def _port_args(f, esm):
    sg = (f["gx"][:-1], f["gy"][:-1]) if esm else None
    return (
        f["I"][:-1].reshape(B, -1).contiguous(),
        tfused.pack_geometry(f["D"][:-1], INTR, 0.3, 5.0, sg).contiguous(),
        f["t_all"][1:].contiguous(), INTR, torch.from_numpy(f["init"]),
    )


def _jax_pair(f, k, esm):
    """pair k as phovo_tpu's kernels take it: (i0 (1, NP), geom (4|6, NP),
    target col-major stack, source image, source depth, source grads)."""
    H, W = SHAPE
    NP, _ = jfused._pick_tile_pixels(H, W)
    si, sd = jnp.asarray(f["I"][k].numpy()), jnp.asarray(f["D"][k].numpy())
    sg = (jnp.asarray(f["gx"][k].numpy()), jnp.asarray(f["gy"][k].numpy())) if esm else None
    tgt = jfused.pack_target_colmajor(*(jnp.asarray(f[n][k + 1].numpy()) for n in ("I", "gx", "gy")))
    return (
        jfused._pad_flat(si.reshape(1, H * W), NP),
        jfused.pack_geometry(sd, JINTR, 0.3, 5.0, NP, sg), tgt, si, sd, sg,
    )


def _assert_level_match(port, state, its, cost, nvalid):
    np.testing.assert_allclose(port.state.numpy(), state, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(port.iterations.numpy(), its)
    np.testing.assert_array_equal(port.num_valid.numpy(), nvalid)
    np.testing.assert_allclose(port.cost.numpy(), cost, rtol=1e-4)


# -- the weights --------------------------------------------------------------


@pytest.mark.parametrize("loss", trobust.LOSSES)
def test_weights_match_jax(loss):
    r = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 0.2
    r[:3] = [0.0, DELTAS[loss], -DELTAS[loss]]
    for fn in ("robust_weight", "sqrt_weight"):
        port = getattr(trobust, fn)(torch.from_numpy(r), loss, DELTAS[loss]).numpy()
        ref = np.asarray(getattr(jrobust, fn)(jnp.asarray(r), loss, DELTAS[loss]))
        np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0)


def test_tdist_scale_update_matches_jax():
    assert (trobust.TDIST_MIN_SCALE, trobust.TDIST_BURNIN, trobust.TDIST_DOF) == (
        jrobust.TDIST_MIN_SCALE, jrobust.TDIST_BURNIN, jrobust.TDIST_DOF,
    )
    cost = np.array([4.0, 0.0, 1e-9, 37.25, 5.0], np.float32)
    nvalid = np.array([100.0, 100.0, 1200.0, 0.0, 1.0], np.float32)
    port = trobust.tdist_scale_update(torch.from_numpy(cost), torch.from_numpy(nvalid)).numpy()
    ref = np.asarray(jrobust.tdist_scale_update(jnp.asarray(cost), jnp.asarray(nvalid)))
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0)
    assert port[1] == np.float32(trobust.TDIST_MIN_SCALE)


# -- K-GN's plain twin against phovo_tpu's batched kernel (B1) ------------------

# (loss, esm, sampling, iterations, min_gradient_norm)
GN_CASES = [
    ("huber", False, "bilinear", 6, 0.0),
    ("cauchy", False, "bilinear", 6, 0.0),
    ("tukey", False, "bilinear", 6, 0.0),
    ("none", True, "bilinear", 6, 0.0),
    ("huber", True, "nearest", 3, 0.0),
    ("tukey", False, "nearest", 3, 0.0),
]


def _gn_id(case):
    loss, esm, sampling, its, mg = case
    return f"{loss}{'-esm' if esm else ''}-{sampling}-{its}it"


@pytest.mark.parametrize("case", GN_CASES, ids=_gn_id)
def test_gn_reference_matches_jax_batch_kernel(frames, case):
    loss, esm, sampling, its, mg = case
    H, W = SHAPE
    pairs = [_jax_pair(frames, k, esm) for k in range(B)]
    ref = jax_gn_batch(
        jnp.concatenate([p[0] for p in pairs]), jnp.stack([p[1] for p in pairs]),
        jnp.stack([p[2] for p in pairs]), JINTR, jnp.asarray(frames["init"]), 0.3, 5.0,
        its, mg, 1.0, H=H, W=W, sampling=sampling, interpret=True, mix_mode="f32",
        robust_loss=loss, robust_delta=DELTAS[loss], esm=esm, streams=1,
    )
    state, r_its, gnorm, cost, nvalid, masked = (np.asarray(x) for x in ref)
    assert np.all(masked == 0)
    port = FB.fused_gn_level_batch_reference(
        *_port_args(frames, esm), its, mg, 1.0, H=H, W=W, sampling=sampling,
        robust_loss=loss, robust_delta=DELTAS[loss], esm=esm,
    )
    _assert_level_match(port, state, r_its, cost, nvalid)
    np.testing.assert_allclose(port.gradient_norm.numpy(), gnorm, rtol=1e-3)
    np.testing.assert_array_equal(port.robust_scale.numpy(), np.float32(DELTAS[loss]))


# -- the Student-t level (B3) ------------------------------------------------------

# (sampling, iterations, burn-in). Nearest stops at 2 iterations: with 4
# burn-in passes the third iteration's states differ by ~1e-5 between
# phovo_tpu's form and the port's, enough to flip one pixel's nearest
# sample on one pair (1180 vs 1181 valid), which moves its state by 4e-4.
TDIST_CASES = [("bilinear", 6, 4), ("bilinear", 5, 0), ("nearest", 2, 4)]


@pytest.mark.parametrize("sampling,its,burnin", TDIST_CASES)
def test_tdist_level_matches_jax_per_pair_kernel(frames, sampling, its, burnin):
    """ops/fused.fused_gn_level (the batched level at B = 1) with the
    Student-t scale, its burn-in at the initial state and its re-estimate
    after every linearization, against phovo_tpu's per-pair kernel B3 (the
    pattern of tests/test_robust.py:250); the final sigma against the scale
    step of phovo_tpu's result."""
    for k in range(B):
        _, _, tgt, si, sd, _ = _jax_pair(frames, k, False)
        init = frames["init"][k]
        ref = jfused.fused_gn_level(
            si, sd, tgt, JINTR, jnp.asarray(init), 0.3, 5.0, its, 0.0, 1.0,
            sampling, interpret=True, mix_mode="f32", robust_loss="tdist",
            robust_delta=0.1, tdist_burnin=burnin,
        )
        state, r_its, gnorm, cost, nvalid, masked = (np.asarray(x) for x in ref)
        assert masked == 0
        port = tfused.fused_gn_level(
            frames["I"][k], frames["D"][k], frames["t_all"][k + 1], INTR,
            torch.from_numpy(init), 0.3, 5.0, its, 0.0, 1.0, sampling,
            robust_loss="tdist", robust_delta=0.1, tdist_burnin=burnin,
        )
        np.testing.assert_allclose(port[0].numpy(), state, rtol=0, atol=2e-4)
        assert int(port[1]) == int(r_its)
        assert float(port[4]) == float(nvalid)
        np.testing.assert_allclose(float(port[3]), float(cost), rtol=1e-4)
        sigma = np.asarray(jrobust.tdist_scale_update(jnp.float32(cost), jnp.float32(nvalid)))
        np.testing.assert_allclose(float(port[6]), float(sigma), rtol=1e-4)


def test_tdist_batch_matches_per_pair_levels(frames):
    """Per-pair sigmas in the batched twin: each pair's level is the one it
    runs alone at B = 1 (the plain version's batched products sum in
    another order than its B = 1 ones, so to 1e-5; the kernel runs each
    pair in its own block, the same bits: tests/test_torch_kernel_cuda.py)."""
    args = _port_args(frames, False)
    scale = torch.tensor([0.1, 0.05, 0.2])
    batch = FB.fused_gn_level_batch(
        *args, 4, 0.0, 1.0, H=SHAPE[0], W=SHAPE[1], sampling="bilinear",
        robust_loss="tdist", robust_scale=scale, tdist_burnin=2,
    )
    for k in range(B):
        one = tfused.fused_gn_level(
            frames["I"][k], frames["D"][k], frames["t_all"][k + 1], INTR,
            args[4][k], 0.3, 5.0, 4, 0.0, 1.0, "bilinear", robust_loss="tdist",
            robust_scale=scale[k], tdist_burnin=2,
        )
        np.testing.assert_allclose(one[0].numpy(), batch.state[k].numpy(), rtol=0, atol=1e-5)
        assert int(one[1]) == int(batch.iterations[k])
        assert float(one[4]) == float(batch.num_valid[k])
        np.testing.assert_allclose(float(one[6]), float(batch.robust_scale[k]), rtol=1e-5)


# -- K-LIN's plain Gram against phovo_tpu's one-linearization kernel (B6) ------


@pytest.mark.parametrize(
    "loss,esm,sampling",
    [("none", False, "nearest"), ("huber", False, "bilinear"), ("cauchy", False, "nearest"),
     ("tukey", False, "bilinear"), ("tdist", False, "bilinear"), ("none", True, "bilinear"),
     ("cauchy", True, "nearest")],
    ids=lambda v: str(v),
)
def test_lin_gram_matches_jax_pallas(frames, loss, esm, sampling):
    k = 1
    _, _, tgt, si, sd, sg = _jax_pair(frames, k, esm)
    state = np.array([0.01, -0.008, 0.012, 0.004, -0.006, 0.003], np.float32)
    ref = jfused.fused_normal_equations_pallas(
        si, sd, tgt, jnp.asarray(state), JINTR, 0.3, 5.0, sampling, interpret=True,
        mix_mode="f32", robust_loss=loss, robust_delta=DELTAS[loss], source_grads=sg,
    )
    port = tfused.fused_normal_equations_pallas(
        frames["I"][k], frames["D"][k], frames["t_all"][k + 1], torch.from_numpy(state),
        INTR, 0.3, 5.0, sampling, robust_loss=loss, robust_delta=DELTAS[loss],
        source_grads=(frames["gx"][k], frames["gy"][k]) if esm else None,
    )
    scale = float(np.abs(np.asarray(ref.JtJ)).max())
    np.testing.assert_allclose(port.JtJ.numpy(), np.asarray(ref.JtJ), rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(port.Jtr.numpy(), np.asarray(ref.Jtr), rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(float(port.cost), float(ref.cost), rtol=1e-5)
    assert float(port.num_valid) == float(ref.num_valid)
    assert float(port.band_masked) == float(ref.band_masked) == 0.0


@pytest.mark.parametrize("gradient_at", ["warped", "esm", "source"])
def test_normal_equations_dispatch_matches_jax(frames, gradient_at):
    """fused_normal_equations dispatches as phovo_tpu's does: 'warped' and
    'esm' to the one-linearization kernel (phovo_tpu on the CPU: its XLA
    routes), 'source' to the exact path in both."""
    k = 2
    state = np.array([0.004, 0.006, -0.01, -0.003, 0.005, 0.002], np.float32)
    names = ("I", "D", "I", "gx", "gy")
    frames_k = [frames[n][k + (i >= 2)] for i, n in enumerate(names)]
    sg = (frames["gx"][k], frames["gy"][k]) if gradient_at == "esm" else None
    ref = jfused.fused_normal_equations(
        *(jnp.asarray(x.numpy()) for x in frames_k), jnp.asarray(state), JINTR, 0.3, 5.0,
        "bilinear", gradient_at, "huber", 0.02,
        None if sg is None else tuple(jnp.asarray(x.numpy()) for x in sg),
    )
    before = FB.LIN_LAUNCHES
    port = tfused.fused_normal_equations(
        *frames_k, torch.from_numpy(state), INTR, 0.3, 5.0, "bilinear", gradient_at,
        "huber", 0.02, sg,
    )
    assert FB.LIN_LAUNCHES == before  # CPU tensors: the plain Gram
    scale = float(np.abs(np.asarray(ref.JtJ)).max())
    np.testing.assert_allclose(port.JtJ.numpy(), np.asarray(ref.JtJ), rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(port.Jtr.numpy(), np.asarray(ref.Jtr), rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(float(port.cost), float(ref.cost), rtol=1e-5)
    assert float(port.num_valid) == float(ref.num_valid)


def test_lin_gram_is_one_level_iteration(frames):
    """The one-linearization twin and one K-GN iteration see the same
    normal equations: one GN step from its Gram lands where the level's
    first iteration does."""
    args = _port_args(frames, True)
    gram = FB.fused_lin_batch(
        *args[:4], args[4], H=SHAPE[0], W=SHAPE[1], sampling="bilinear",
        robust_loss="huber", robust_delta=0.02, esm=True,
    )
    level = FB.fused_gn_level_batch(
        *args, 1, 0.0, 1.0, H=SHAPE[0], W=SHAPE[1], sampling="bilinear",
        robust_loss="huber", robust_delta=0.02, esm=True,
    )
    np.testing.assert_allclose(gram[:, 6, 6].numpy(), level.cost.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(gram[:, 7, 7].numpy(), level.num_valid.numpy())
    np.testing.assert_allclose(
        torch.linalg.vector_norm(gram[:, :6, 6], dim=1).numpy(), level.gradient_norm.numpy(), rtol=1e-5,
    )
    step = torch.linalg.solve(gram[:, :6, :6].double(), gram[:, :6, 6:7].double())[..., 0]
    np.testing.assert_allclose((args[4] - step).numpy(), level.state.numpy(), rtol=0, atol=1e-5)


# -- K-TR's plain twin with robust losses against phovo_tpu's B2 -----------------

TIGHT = dict(function_tolerance=1e-9, gradient_tolerance=1e-12, parameter_tolerance=1e-10)
# cauchy at 0.05 here: at 0.02 the trust-region step on the third occluded
# pair turns float32 sum-order noise into states 7e-6 apart after one
# iteration and costs 4.5e-4 apart (the same code in both, checked
# iteration by iteration; the Gauss-Newton level's states stay 1e-6 apart)
TR_DELTAS = dict(DELTAS, cauchy=0.05)


@pytest.mark.parametrize("loss", ["huber", "cauchy", "tukey"])
def test_tr_reference_with_robust_loss_matches_jax(frames, loss):
    H, W = SHAPE
    pairs = [_jax_pair(frames, k, False) for k in range(B)]
    ref = jax_tr_batch(
        jnp.concatenate([p[0] for p in pairs]), jnp.stack([p[1] for p in pairs]),
        jnp.stack([p[2] for p in pairs]), JINTR, jnp.asarray(frames["init"]), 0.3, 5.0,
        JTROptions(max_iterations=4, **TIGHT), H=H, W=W, sampling="bilinear",
        interpret=True, mix_mode="f32", robust_loss=loss, robust_delta=TR_DELTAS[loss],
        streams=1,
    )
    state, its, cost, gnorm, radius, nvalid, masked = (np.asarray(x) for x in ref)
    assert np.all(masked == 0)
    port = FB.fused_tr_level_batch_reference(
        *_port_args(frames, False), TROptions(4, **TIGHT), H=H, W=W,
        robust_loss=loss, robust_delta=TR_DELTAS[loss],
    )
    np.testing.assert_allclose(port.state.numpy(), state, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(port.iterations.numpy(), its)
    np.testing.assert_allclose(port.cost.numpy(), cost, rtol=1e-4)
    np.testing.assert_array_equal(port.num_valid.numpy(), nvalid)
    np.testing.assert_allclose(port.gradient_norm.numpy(), gnorm, rtol=1e-3)
    np.testing.assert_allclose(port.radius.numpy(), radius, rtol=1e-4)


# -- the robust aligner on an occluded pair (the port alone) ---------------------

OCC_INTR = Intrinsics(128.0, 128.0, 63.5, 47.5)
OCC_SHAPE = (96, 128)
K_OCC = [[128.0, 0.0, 63.5], [0.0, 128.0, 47.5], [0.0, 0.0, 1.0]]


def _occ_cfg(robust_loss="none", robust_delta=0.1):
    """tests/test_robust.py's _cfg."""
    return PhovoConfig(
        num_levels=2, blur_filter_sizes=(0, 0), gradient_scales=(0.0625, 0.0625),
        max_iterations=(10, 15), lambda_steps=(1.0, 1.0), min_gradient_norms=(1e-10, 1e-10),
        sampling="bilinear", robust_loss=robust_loss, robust_delta=robust_delta,
    )


def _occluded_pair(occ_frac):
    """tests/test_robust.py's _corrupted_pair: a smooth 0.95 patch pasted
    into the target."""
    I0, D0, I1, D1, gt = make_pair(OCC_INTR, shape=OCC_SHAPE)
    H, W = OCC_SHAPE
    hh, ww = int(H * occ_frac), int(W * occ_frac * 2)
    I1 = I1.copy()
    I1[10:10 + hh, 20:20 + ww] = 0.95
    return I0, D0, I1, D1, gt


def _occ_error(pair, cfg):
    I0, D0, I1, D1, gt = pair
    vo = PhotoconsistencyOdometryAnalytic(cfg, device="cpu")
    vo.set_intrinsic_matrix(K_OCC)
    vo.set_source_frame((I0 * 255).astype(np.uint8), D0)
    vo.set_target_frame((I1 * 255).astype(np.uint8), D1)
    vo.set_initial_state_vector(np.zeros(6))
    return float(np.abs(vo.optimize().state.numpy() - gt).max())


@pytest.fixture(scope="module")
def occluded():
    pair = _occluded_pair(0.22)
    return pair, _occ_error(pair, _occ_cfg())


# tests/test_robust.py:117-128 (huber, cauchy, tukey) and :221-241 (tdist)
@pytest.mark.parametrize(
    "loss,delta,bound,cut",
    [("huber", 0.02, 0.4, 3), ("cauchy", 0.02, 0.06, 3), ("tukey", 0.1, 0.06, 3),
     ("tdist", 0.1, 0.15, 4)],
)
def test_robust_aligner_resists_occlusion(occluded, loss, delta, bound, cut):
    pair, err_plain = occluded
    assert err_plain > 0.2  # the quadratic cost diverges on this pair
    err = _occ_error(pair, _occ_cfg(loss, delta))
    assert err < err_plain / cut, (loss, err_plain, err)
    assert err < bound, (loss, err)


def test_tdist_aligner_resists_a_moderate_occluder():
    err = _occ_error(_occluded_pair(0.12), _occ_cfg("tdist", 0.1))
    assert err < 0.06, err


def test_robust_matches_plain_on_clean_data():
    pair = make_pair(OCC_INTR, shape=OCC_SHAPE)
    I0, D0, I1, D1, gt = pair
    states = {}
    for name, cfg in {"none": _occ_cfg(), "huber": _occ_cfg("huber", 0.3),
                      "tdist": _occ_cfg("tdist", 0.1)}.items():
        vo = PhotoconsistencyOdometryAnalytic(cfg, device="cpu")
        vo.set_intrinsic_matrix(K_OCC)
        vo.set_source_frame((I0 * 255).astype(np.uint8), D0)
        vo.set_target_frame((I1 * 255).astype(np.uint8), D1)
        states[name] = vo.optimize().state.numpy()
    np.testing.assert_allclose(states["huber"], states["none"], atol=2e-4)
    np.testing.assert_allclose(states["tdist"], states["none"], atol=5e-4)

