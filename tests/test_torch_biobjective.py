"""The bi-objective (intensity + depth) backend: phovo_tpu_torch against
phovo_tpu on the CPU, on the same numpy frames.

Three layers:
  * the exact residuals, biobjective_residual_jacobian (and
    warp_and_jacobian's rigid Jacobian), at 96x128 from a seeded state:
    valid equal, r within 1e-5, J within 1e-5 of its largest entry
    (tests/test_torch_ops.py's scaled bound: the warped column differs by
    an ulp or two, and next to the target's depth hole the sampled depth
    gradient moves by 0.4 a pixel);
  * K-GN-bi's plain version (fused_gn_level_batch_reference with
    depth_gains) against phovo_tpu's two bi-objective kernels in interpret
    mode: the per-pair _fused_gn_bi_kernel (fused_gn_level with
    depth_cols) at B = 1, and the batched kernel's bi mode
    (fused_gn_level_batch with depth_gains) at B = 3 over streams=2, so
    one pad pair. Only at H <= 48, where neither kernel narrows its row
    window to a band (ops/fused.py:575-577, ops/fused_batch.py:72,
    :261-265), so both sample every row like the port; their band_masked
    is asserted 0. Init states are small seeded perturbations of zero;
  * the backend: align_biobjective, align_sequence_biobjective (zero init
    and warm_start), align_sequence_chunk_biobjective, the object API and
    BACKENDS["biobjective"] against phovo_tpu's, whose CPU route is its
    XLA path (the exact residuals, normal_equations and
    gauss_newton_level), on a 4-frame make_sequence chain at 96x128, 3
    levels, a bright occluder in every target. The frames' depth is zero
    on an 8-pixel border: from the zero state a border pixel warps onto
    the bilinear in-bounds edge u = 0, where the two forms round to
    opposite sides (tests/test_torch_analytic.py).

Tolerances: states 2e-4 absolute (float32 pixel sums in another order,
amplified by the 6x6 solve; tests/test_fused_batch.py's level),
iterations and valid counts equal, costs 1e-4 relative. One exception,
measured and explained: the backend's bilinear 'none' chains hold costs to
5e-4. The depth-less border is a 2 m step in every target depth; pixels
that warp next to it carry a depth residual of ~gain x 2 m whose bilinear
sample moves by ~0.5 per pixel of warp, so the ~1e-5 state difference
left by the summation order moves such a cost by up to 3.1e-4 (measured
here on the CPU; with a robust loss those pixels are down-weighted and the
costs agree to 2e-5). Nearest runs one iteration a level, bilinear the
whole schedule (tests/test_torch_analytic.py); the early-exit thresholds
sit at least 7% from every ||J^T r|| the plain version reads before a
stop.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phovo_tpu.models.biobjective import PhotoconsistencyOdometryBiObjective as JaxBi
from phovo_tpu.models.biobjective import align_biobjective as jax_align_bi
from phovo_tpu.models.biobjective import align_sequence_biobjective as jax_align_sequence_bi
from phovo_tpu.models.biobjective import align_sequence_chunk_biobjective as jax_align_chunk_bi
from phovo_tpu.ops import fused as jfused
from phovo_tpu.ops import pyramid as jpyr
from phovo_tpu.ops import residuals as jres
from phovo_tpu.ops.camera import Intrinsics as JIntrinsics
from phovo_tpu.ops.fused_batch import fused_gn_level_batch as jax_level_batch
from phovo_tpu.utils.config import PhovoConfig as JaxConfig
import phovo_tpu_torch
from phovo_tpu_torch.models import BACKENDS
from phovo_tpu_torch.models import biobjective as tbi
from phovo_tpu_torch.ops import fused as tfused
from phovo_tpu_torch.ops import fused_batch as FB
from phovo_tpu_torch.ops import pyramid as tpyr
from phovo_tpu_torch.ops import residuals as tres
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.utils.config import PhovoConfig
from phovo_tpu_torch.utils.synthetic import make_sequence

torch.set_num_threads(1)

SCALE = 0.0625
MAX_DEPTH = 5.0
EARLY_EXIT_MARGIN = 1.07


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax(x):
    return jax.tree.map(np.asarray, jax.device_get(x))


# -- the exact residuals --------------------------------------------------------


@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
@pytest.mark.parametrize("gradient_at", ["warped", "source"])
def test_biobjective_residual_jacobian_matches_jax(sampling, gradient_at):
    intr = Intrinsics(128.0, 128.0, 63.5, 47.5)
    jintr = JIntrinsics(*(np.float32(v) for v in intr))
    I, D, _, _ = make_sequence(intr, (96, 128), 2, seed=3)
    D = np.stack(D)
    D[1, 40:60, 50:90] = 0.0  # a hole in the target depth
    I = np.stack(I)
    state = np.array([0.01, -0.006, 0.012, 0.004, -0.003, 0.005], np.float32)
    gx, gy = (np.asarray(g[0]) for g in jpyr.build_gradient_pyramid([jnp.asarray(I[1])], (SCALE,)))
    dn = (D[1] * np.float32(1.0 / MAX_DEPTH)).astype(np.float32)
    dgx, dgy = (np.asarray(g[0]) for g in jpyr.build_gradient_pyramid([jnp.asarray(dn)], (SCALE,)))
    args = (I[0], D[0], I[1], D[1], gx, gy, dgx, dgy, state)
    kw = dict(min_depth=0.3, max_depth=MAX_DEPTH, sampling=sampling, gradient_at=gradient_at)
    jr, jJ, jv = _jax(jres.biobjective_residual_jacobian(*map(jnp.asarray, args), jintr, **kw))
    r, J, v = tres.biobjective_residual_jacobian(*map(_t, args), intr, **kw)
    assert r.shape == (2, 96, 128) and J.shape == (2, 96, 128, 6) and v.shape == (96, 128)
    np.testing.assert_array_equal(v.numpy(), jv)
    np.testing.assert_allclose(r.numpy(), jr, rtol=0, atol=1e-5)
    np.testing.assert_allclose(J.numpy(), jJ, rtol=0, atol=1e-5 * float(np.abs(jJ).max()))
    assert float(np.abs(jr[1]).max()) > 0.1  # the depth channel is live
    # the rigid Jacobian behind the depth row
    *_, J_rt = tres.warp_and_jacobian(_t(D[0]), _t(state), intr, 0.3, MAX_DEPTH, return_rigid=True)
    *_, jJ_rt = jres.warp_and_jacobian(jnp.asarray(D[0]), jnp.asarray(state), jintr, 0.3, MAX_DEPTH,
                                       return_rigid=True)
    np.testing.assert_allclose(J_rt.numpy(), np.asarray(jJ_rt), rtol=0, atol=1e-6)
    assert len(tres.warp_and_jacobian(_t(D[0]), _t(state), intr, 0.3, MAX_DEPTH)) == 5
    # normal_equations counts each valid pixel once over the two channels
    ne = tres.normal_equations(r, J, v, "cauchy", 0.05)
    jne = _jax(jres.normal_equations(jnp.asarray(jr), jnp.asarray(jJ), jnp.asarray(jv), "cauchy", 0.05))
    assert float(ne.num_valid) == float(jne.num_valid) == float(v.sum())
    np.testing.assert_allclose(ne.JtJ.numpy(), jne.JtJ, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(ne.cost), float(jne.cost), rtol=1e-4)


# -- K-GN-bi's plain version against phovo_tpu's bi-objective kernels ----------

B = 3
# (shape, sampling, iterations, min_gradient_norm, loss at tests/test_robust.py's scale)
LEVEL_CASES = [
    ((24, 32), "nearest", 3, 0.0, "none"),
    ((24, 32), "nearest", 4, 8.7404, "tukey"),  # the pairs stop after 3, 3, 4
    ((48, 64), "bilinear", 6, 0.0, "none"),
    ((48, 64), "bilinear", 8, 4.1656, "cauchy"),  # all stop after 7
]
DELTAS = {"none": 0.1, "huber": 0.02, "cauchy": 0.02, "tukey": 0.1}


def _level_id(case):
    shape, sampling, its, mg, loss = case
    return f"{shape[0]}x{shape[1]}-{sampling}-{its}it-g{mg:g}-{loss}"


@pytest.fixture(scope="module")
def level_frames():
    """Per shape: B + 1 frames (intensity, depth, their Scharr gradients,
    the depth gradients of depth / max_depth), the gains, seeded inits."""
    out = {}
    for H, W in {case[0] for case in LEVEL_CASES}:
        intr = Intrinsics(float(W), float(W), W / 2 - 0.5, H / 2 - 0.5)
        I, D, _, _ = make_sequence(intr, (H, W), B + 1, motion_scale=2.0, seed=H)
        I, D = np.stack(I), np.stack(D)
        gx, gy = (np.asarray(g[0]) for g in jpyr.build_gradient_pyramid([jnp.asarray(I)], (SCALE,)))
        dn = (D * np.float32(1.0 / MAX_DEPTH)).astype(np.float32)
        dgx, dgy = (np.asarray(g[0]) for g in jpyr.build_gradient_pyramid([jnp.asarray(dn)], (SCALE,)))
        gains = (I.mean(axis=(1, 2)) / D.mean(axis=(1, 2))).astype(np.float32)
        init = (np.random.default_rng(H).standard_normal((B, 6)) * 1e-3).astype(np.float32)
        out[(H, W)] = dict(intr=intr, I=I, D=D, gx=gx, gy=gy, dgx=dgx, dgy=dgy, gains=gains, init=init)
    return out


def _port_args(f, H, W):
    """The port's batched level inputs: pair k is frame k -> k + 1."""
    It, Dt = _t(f["I"]), _t(f["D"])
    t6 = tfused.pack_target(It, _t(f["gx"]), _t(f["gy"]), (Dt, _t(f["dgx"]), _t(f["dgy"])))
    return (It[:-1].reshape(B, -1).contiguous(), tfused.pack_geometry(Dt[:-1], f["intr"], 0.3, MAX_DEPTH),
            t6[1:].contiguous(), f["intr"], _t(f["init"]))


def _port_level(f, case, fn=FB.fused_gn_level_batch):
    (H, W), sampling, its, mg, loss = case
    return fn(*_port_args(f, H, W), its, mg, 1.0, H=H, W=W, sampling=sampling, robust_loss=loss,
              robust_delta=DELTAS[loss], depth_gains=_t(f["gains"][1:]))


@pytest.fixture(scope="module")
def jax_levels(level_frames):
    """Per case: phovo_tpu's batched bi kernel (streams=2) and its per-pair
    bi kernel for each pair, in interpret mode."""
    out = {}
    for case in LEVEL_CASES:
        (H, W), sampling, its, mg, loss = case
        f = level_frames[(H, W)]
        jintr = JIntrinsics(*(np.float32(v) for v in f["intr"]))
        NP, _ = jfused._pick_tile_pixels(H, W)
        kw = dict(interpret=True, mix_mode="f32", robust_loss=loss, robust_delta=DELTAS[loss])

        def t6(k):
            return jnp.concatenate(
                [jfused.pack_target_colmajor(*(jnp.asarray(f[c][k]) for c in ("I", "gx", "gy")))]
                + [jfused._pad_channel_rows(jnp.asarray(f[c][k])) for c in ("D", "dgx", "dgy")]
            )

        batch = jax_level_batch(
            jnp.concatenate([jfused._pad_flat(jnp.asarray(f["I"][k]).reshape(1, H * W), NP) for k in range(B)]),
            jnp.stack([jfused.pack_geometry(jnp.asarray(f["D"][k]), jintr, 0.3, MAX_DEPTH, NP) for k in range(B)]),
            jnp.stack([t6(k) for k in range(1, B + 1)]), jintr, jnp.asarray(f["init"]), 0.3, MAX_DEPTH,
            its, mg, 1.0, H=H, W=W, sampling=sampling, streams=2,
            depth_gains=jnp.asarray(f["gains"][1:]), **kw,
        )
        @jax.jit  # one compile for the case's three pairs
        def per_pair_level(si, sd, ti, gx, gy, init, d, dgx, dgy, gain):
            return jfused.fused_gn_level(
                si, sd, jfused.pack_target_colmajor(ti, gx, gy), jintr, init, 0.3, MAX_DEPTH,
                its, mg, 1.0, sampling, depth_cols=(d, dgx, dgy), depth_gain=gain, **kw,
            )

        per_pair = [
            per_pair_level(
                f["I"][k], f["D"][k], *(f[c][k + 1] for c in ("I", "gx", "gy")), f["init"][k],
                *(f[c][k + 1] for c in ("D", "dgx", "dgy")), f["gains"][k + 1],
            )
            for k in range(B)
        ]
        out[case] = dict(batch=_jax(batch), per_pair=[_jax(p) for p in per_pair])
    return out


def _assert_level_match(port, state, its, gnorm, cost, nvalid):
    np.testing.assert_allclose(port.state.numpy(), state, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(port.iterations.numpy(), its)
    np.testing.assert_array_equal(port.num_valid.numpy(), nvalid)
    np.testing.assert_allclose(port.cost.numpy(), cost, rtol=1e-4)
    np.testing.assert_allclose(port.gradient_norm.numpy(), gnorm, rtol=1e-3)


@pytest.mark.parametrize("case", LEVEL_CASES, ids=_level_id)
def test_bi_level_matches_jax_batch_kernel(level_frames, jax_levels, case):
    """(b) The batched plain version against phovo_tpu's batched bi mode."""
    state, its, gnorm, cost, nvalid, band_masked = jax_levels[case]["batch"]
    assert np.all(band_masked == 0)
    port = _port_level(level_frames[case[0]], case)
    _assert_level_match(port, state, its, gnorm, cost, nvalid)
    if case[3] > 0:  # the threshold froze pairs before the budget
        assert int(its.min()) < case[2], its


@pytest.mark.parametrize("case", LEVEL_CASES, ids=_level_id)
def test_bi_level_at_one_pair_matches_jax_per_pair_kernel(level_frames, jax_levels, case):
    """(a) B = 1 (ops/fused.fused_gn_level with depth_cols, B4's port)
    against phovo_tpu's per-pair bi kernel, pair by pair."""
    (H, W), sampling, its, mg, loss = case
    f = level_frames[(H, W)]
    for k in range(B):
        state, r_its, gnorm, cost, nvalid, masked = jax_levels[case]["per_pair"][k]
        assert masked == 0
        port = tfused.fused_gn_level(
            _t(f["I"][k]), _t(f["D"][k]),
            tfused.pack_target(*(_t(f[c][k + 1]) for c in ("I", "gx", "gy"))), f["intr"],
            _t(f["init"][k]), 0.3, MAX_DEPTH, its, mg, 1.0, sampling,
            depth_cols=tuple(_t(f[c][k + 1]) for c in ("D", "dgx", "dgy")),
            depth_gain=float(f["gains"][k + 1]), robust_loss=loss, robust_delta=DELTAS[loss],
        )
        np.testing.assert_allclose(port[0].numpy(), state, rtol=0, atol=2e-4)
        assert int(port[1]) == int(r_its) and float(port[4]) == float(nvalid)
        np.testing.assert_allclose(float(port[3]), float(cost), rtol=1e-4)
        np.testing.assert_allclose(float(port[2]), float(gnorm), rtol=1e-3)
        assert float(port[5]) == 0.0


@pytest.mark.parametrize("case", [c for c in LEVEL_CASES if c[3] > 0], ids=_level_id)
def test_bi_early_exit_thresholds_are_off_their_boundaries(level_frames, case):
    """Every ||J^T r|| the plain version reads up to a pair's stop lies at
    least 7% from the threshold, so another summation order cannot flip
    the stop."""
    (H, W), sampling, its, mg, loss = case
    f = level_frames[(H, W)]
    stops = _port_level(f, case).iterations
    gnorm = torch.stack([
        _port_level(f, ((H, W), sampling, n, 0.0, loss)).gradient_norm for n in range(1, its + 1)
    ])
    for k, stop in enumerate(stops.tolist()):
        ratio = gnorm[:stop, k] / mg
        assert bool(((ratio >= EARLY_EXIT_MARGIN) | (ratio <= 1 / EARLY_EXIT_MARGIN)).all()), (k, ratio)


@pytest.mark.parametrize("iterations", [1, 4])
def test_bi_plain_version_sums_the_two_channels(level_frames, iterations):
    """The depth channel reaches the normal equations: with a zero gain the
    bi level is the photometric level (every depth row and residual is 0),
    a nonzero gain moves the result, and at the same state (one
    iteration) the valid count is the intensity's alone."""
    f = level_frames[(24, 32)]
    args = _port_args(f, 24, 32)
    kw = dict(H=24, W=32, sampling="bilinear")
    photo = FB.fused_gn_level_batch(*args[:2], args[2][:, :3].contiguous(), *args[3:], iterations, 0.0, 1.0, **kw)
    zero = FB.fused_gn_level_batch(*args, iterations, 0.0, 1.0, depth_gains=torch.zeros(B), **kw)
    for a, b in zip(photo, zero):
        assert torch.equal(a, b)
    bi = _port_level(f, ((24, 32), "bilinear", iterations, 0.0, "none"))
    assert float((bi.state - photo.state).abs().max()) > 1e-5
    assert float((bi.cost - photo.cost).abs().min()) > 0.0
    if iterations == 1:
        assert torch.equal(bi.num_valid, photo.num_valid)


# -- the backend against phovo_tpu ----------------------------------------------

SHAPE = (96, 128)
N_FRAMES = 4
INTR = Intrinsics(128.0, 128.0, 63.5, 47.5)
JINTR = JIntrinsics(*(np.float32(v) for v in INTR))
DEPTH_SCALE = 1.0 / 5000.0

BASE = JaxConfig(
    num_levels=3, blur_filter_sizes=(0,) * 3, gradient_scales=(0.0625,) * 3,
    max_iterations=(3, 3, 4), lambda_steps=(1.0,) * 3, min_gradient_norms=(0.0,) * 3,
    sampling="bilinear", mix_mode="f32",
)
NEAREST = dict(sampling="nearest", max_iterations=(1, 1, 1))
EARLY = dict(max_iterations=(0, 0, 8))
VARIANTS = {
    "none": {},
    "huber": dict(robust_loss="huber", robust_delta=0.02),
    "cauchy": dict(robust_loss="cauchy", robust_delta=0.02),
    "source": dict(gradient_at="source"),
    # blurred intensity pyramids (depth stays unblurred), level 0 skipped
    "blur-skip": dict(blur_filter_sizes=(3, 3, 3), max_iterations=(0, 3, 4)),
    "none-nearest": dict(NEAREST),
    "cauchy-nearest": dict(robust_loss="cauchy", robust_delta=0.02, **NEAREST),
    # the pairs stop after [6, 2, 4] and [5, 6, 7] iterations
    "early-none": dict(EARLY, min_gradient_norms=(2.7842,) * 3),
    "early-cauchy": dict(EARLY, robust_loss="cauchy", robust_delta=0.02, min_gradient_norms=(1.2702,) * 3),
}
EARLY_NAMES = [name for name in VARIANTS if name.startswith("early")]
# bilinear 'none' chains: the depth-less border's step (module docstring)
COST_RTOL = {"none": 5e-4, "source": 5e-4, "blur-skip": 5e-4, "early-none": 5e-4}


def _jcfg(name):
    return dataclasses.replace(BASE, **VARIANTS[name])


def _tcfg(name):
    return PhovoConfig.from_dict(dataclasses.asdict(_jcfg(name)))


@pytest.fixture(scope="module")
def frames():
    I, D, _, _ = make_sequence(INTR, SHAPE, N_FRAMES, seed=2)
    I, D = np.stack(I), np.stack(D)
    I[1:, 10:30, 70:100] = 0.95  # an occluder in every target
    for edge in (np.s_[:, :8], np.s_[:, -8:], np.s_[:, :, :8], np.s_[:, :, -8:]):
        D[edge] = 0.0
    I8 = np.round(I * 255.0).astype(np.uint8)
    D16 = np.round(D / DEPTH_SCALE).astype(np.uint16)
    return dict(I=I, D=D, I8=I8, D16=D16)


@pytest.fixture(scope="module")
def jax_scans(frames):
    """phovo_tpu's align_sequence_biobjective (a scan of align_biobjective
    from zero on its CPU route) per variant, on uint8 frames."""
    return {
        name: _jax(jax_align_sequence_bi(frames["I8"], frames["D"], JINTR, _jcfg(name)))
        for name in VARIANTS
    }


def _assert_match(port, ref, name):
    np.testing.assert_allclose(port.state.numpy(), ref.state, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(port.iterations.numpy(), ref.iterations)
    np.testing.assert_array_equal(port.num_valid.numpy(), ref.num_valid)
    np.testing.assert_allclose(port.cost.numpy(), ref.cost, rtol=COST_RTOL.get(name, 1e-4))
    assert float(port.band_masked.abs().sum()) == 0.0


@pytest.mark.parametrize("name", list(VARIANTS))
def test_align_biobjective_matches_jax(frames, jax_scans, name):
    """Per pair: one K-GN-bi call per active level at B = 1 (the exact
    torch path for 'source')."""
    port = [
        tbi.align_biobjective(
            _t(frames["I8"][k]), _t(frames["D"][k]), _t(frames["I8"][k + 1]),
            _t(frames["D"][k + 1]), INTR, torch.zeros(6), _tcfg(name),
        )
        for k in range(N_FRAMES - 1)
    ]
    _assert_match(tbi.AlignmentResult(*(torch.stack(x) for x in zip(*port))), jax_scans[name], name)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_align_sequence_biobjective_matches_jax(frames, jax_scans, name):
    """The zero-init chain: level-major through K-GN-bi's plain version, the
    exact path pair after pair for 'source'."""
    port = tbi.align_sequence_biobjective(_t(frames["I8"]), _t(frames["D"]), INTR, _tcfg(name))
    _assert_match(port, jax_scans[name], name)
    if name == "blur-skip":  # a skipped level passes the state through
        assert int(port.iterations[:, 0].abs().sum()) == 0
        assert float(port.cost[:, 0].abs().sum()) == 0.0


@pytest.mark.parametrize("name", ["none", "cauchy-nearest", "source"])
def test_use_fused_false_matches_jax(frames, name):
    """use_fused=False: the exact torch path against phovo_tpu's."""
    ref = _jax(jax_align_sequence_bi(frames["I"], frames["D"], JINTR, _jcfg(name), use_fused=False))
    before = FB.LAUNCHES
    port = tbi.align_sequence_biobjective(_t(frames["I"]), _t(frames["D"]), INTR, _tcfg(name), use_fused=False)
    _assert_match(port, ref, name)
    vo = tbi.PhotoconsistencyOdometryBiObjective(_tcfg(name), device="cpu")
    full = vo.align_full_band(_t(frames["I"][0]), _t(frames["D"][0]), _t(frames["I"][1]),
                              _t(frames["D"][1]), INTR, torch.zeros(6))
    np.testing.assert_array_equal(full.state.numpy(), port.state[0].numpy())
    assert FB.LAUNCHES == before


@pytest.mark.parametrize("name", ["none", "early-cauchy", "cauchy-nearest"])
def test_warm_started_sequence_matches_jax(frames, name):
    """warm_start: each pair starts where the one before ended (the serial
    chain over per-frame products computed once)."""
    ref = _jax(jax_align_sequence_bi(frames["I"], frames["D"], JINTR, _jcfg(name), warm_start=True))
    port = tbi.align_sequence_biobjective(_t(frames["I"]), _t(frames["D"]), INTR, _tcfg(name), warm_start=True)
    _assert_match(port, ref, name)
    zero = tbi.align_sequence_biobjective(_t(frames["I"]), _t(frames["D"]), INTR, _tcfg(name))
    assert not torch.equal(port.state[1:], zero.state[1:])


@pytest.mark.parametrize("name,warm_start", [("none-nearest", False), ("huber", True)])
def test_align_sequence_chunk_biobjective_matches_jax(frames, name, warm_start):
    """uint8 intensity and uint16 depth counts converted on the device, the
    carry frame prepended there. The warm chain runs bilinear: nearest
    pairs started from the states where the pair before ended (4.9e-5
    apart) land up to 5.2e-3 apart after one iteration a level on the
    quantized depth (measured on the CPU; ROADMAP.md §C)."""
    args = (frames["I8"][0], frames["D"][0], frames["I8"][1:], frames["D16"][1:])
    ref, jci, jcd = jax_align_chunk_bi(
        *args, JINTR, _jcfg(name), warm_start=warm_start, depth_scale=DEPTH_SCALE,
    )
    port, ci, cd = tbi.align_sequence_chunk_biobjective(
        *map(_t, args), INTR, _tcfg(name), warm_start=warm_start, depth_scale=DEPTH_SCALE,
    )
    _assert_match(port, _jax(ref), name)
    np.testing.assert_array_equal(ci.numpy(), np.asarray(jci))
    np.testing.assert_array_equal(cd.numpy(), np.asarray(jcd))


@pytest.mark.parametrize("name", EARLY_NAMES)
def test_early_exit_thresholds_are_off_their_boundaries(frames, name):
    """Every ||J^T r|| the plain level reads up to the iteration where an
    early-exit schedule stops a pair lies at least 7% from its
    min_gradient_norm; the pairs stop after different counts, one at least
    before the budget."""
    cfg = _tcfg(name)
    level, n = 2, cfg.max_iterations[2]
    I = _t(frames["I8"]).to(torch.float32) * (1.0 / 255.0)
    D = _t(frames["D"])
    stops = tbi.align_sequence_biobjective(_t(frames["I8"]), D, INTR, cfg).iterations[:, level]
    i0, geom, t6, gains = tbi.prep_frame_biobjective(I, D, INTR, cfg)[level]
    H, W = tpyr.level_shape(SHAPE, level)
    gnorm = torch.stack([
        FB.fused_gn_level_batch(
            i0[:-1], geom[:-1], t6[1:], INTR.at_level(level), torch.zeros((N_FRAMES - 1, 6)),
            it, 0.0, 1.0, H=H, W=W, sampling=cfg.sampling, robust_loss=cfg.robust_loss,
            robust_delta=cfg.robust_delta, depth_gains=gains[1:],
        ).gradient_norm
        for it in range(1, n + 1)
    ])
    assert len(set(stops.tolist())) > 1 and int(stops.min()) < n, stops
    for k, stop in enumerate(stops.tolist()):
        ratio = gnorm[:stop, k] / cfg.min_gradient_norms[level]
        assert bool(((ratio >= EARLY_EXIT_MARGIN) | (ratio <= 1 / EARLY_EXIT_MARGIN)).all()), (k, ratio)


def test_object_api_matches_jax(frames):
    """The reference's object interface with both depths: intrinsics,
    frames (uint8 and metric depth), an initial state, optimize, the
    optimal state and its rigid transformation."""
    K = [[INTR.fx, 0.0, INTR.cx], [0.0, INTR.fy, INTR.cy], [0.0, 0.0, 1.0]]
    init = np.array([0.002, -0.001, 0.003, 0.001, 0.0, -0.002], np.float32)
    out = []
    for make in (lambda: JaxBi(_jcfg("cauchy")),
                 lambda: BACKENDS["biobjective"](_tcfg("cauchy"), device="cpu")):
        vo = make()
        vo.set_intrinsic_matrix(np.asarray(K))
        vo.set_source_frame(frames["I8"][0], frames["D"][0])
        vo.set_target_frame(frames["I8"][1], frames["D"][1])
        vo.set_initial_state_vector(init)
        res = vo.optimize()
        out.append((np.asarray(vo.get_optimal_state_vector()),
                    np.asarray(vo.get_optimal_rigid_transformation_matrix()), res))
    (js, jT, jres_), (ts, tT, tres_) = out
    np.testing.assert_allclose(ts, js, rtol=0, atol=2e-4)
    np.testing.assert_allclose(tT, jT, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(tres_.iterations.numpy(), np.asarray(jres_.iterations))
    np.testing.assert_array_equal(tres_.num_valid.numpy(), np.asarray(jres_.num_valid))


def test_exports():
    assert BACKENDS["biobjective"] is tbi.PhotoconsistencyOdometryBiObjective
    assert phovo_tpu_torch.PhotoconsistencyOdometryBiObjective is tbi.PhotoconsistencyOdometryBiObjective
    for name in ("align_biobjective", "align_sequence_biobjective", "align_sequence_chunk_biobjective"):
        assert getattr(phovo_tpu_torch, name) is getattr(tbi, name)


def test_cpu_routes_launch_nothing(frames):
    """Every bi-objective entry point on CPU tensors runs the plain
    versions."""
    before = (FB.LAUNCHES, FB.TR_LAUNCHES, FB.LIN_LAUNCHES)
    I, D = _t(frames["I"]), _t(frames["D"])
    tbi.align_sequence_biobjective(I, D, INTR, _tcfg("huber"), warm_start=True)
    tbi.align_sequence_biobjective(I, D, INTR, _tcfg("huber"))
    tbi.align_biobjective(I[0], D[0], I[1], D[1], INTR, torch.zeros(6), _tcfg("huber"))
    assert (FB.LAUNCHES, FB.TR_LAUNCHES, FB.LIN_LAUNCHES) == before


@pytest.mark.parametrize(
    "change,match",
    [(dict(gradient_at="esm"), "gradient_at='esm'"), (dict(robust_loss="tdist"), "tdist")],
    ids=["esm", "tdist"],
)
def test_photometric_only_options_raise_everywhere(frames, change, match):
    """ESM and the Student-t loss are photometric-only: every entry point
    and the kernel wrappers raise phovo_tpu's ValueError
    (tests/test_robust.py:290-302, tests/test_esm.py:125)."""
    cfg = dataclasses.replace(_tcfg("none"), **change)
    I, D = _t(frames["I"]), _t(frames["D"])
    with pytest.raises(ValueError, match=match):  # phovo_tpu raises it too
        jax_align_bi(frames["I"][0], frames["D"][0], frames["I"][1], frames["D"][1], JINTR,
                     jnp.zeros(6), dataclasses.replace(_jcfg("none"), **change))
    calls = [
        lambda: tbi.align_biobjective(I[0], D[0], I[1], D[1], INTR, torch.zeros(6), cfg),
        lambda: tbi.align_biobjective(I[0], D[0], I[1], D[1], INTR, torch.zeros(6), cfg, use_fused=False),
        lambda: tbi.align_sequence_biobjective(I, D, INTR, cfg),
        lambda: tbi.align_sequence_biobjective(I, D, INTR, cfg, warm_start=True),
        lambda: tbi.align_sequence_chunk_biobjective(I[0], D[0], I[1:], D[1:], INTR, cfg),
        lambda: tbi.PhotoconsistencyOdometryBiObjective(cfg, device="cpu").align(
            I[0], D[0], I[1], D[1], INTR, torch.zeros(6)),
    ]
    for call in calls:
        with pytest.raises(ValueError, match=match):
            call()
    t6 = tfused.pack_target(I[1], I[1], I[1], (D[1], D[1], D[1]))
    kw = dict(depth_cols=(D[1], D[1], D[1]), depth_gain=0.25)
    if "esm" in change.values():
        kw["source_grads"] = (I[0], I[0])
    else:
        kw["robust_loss"] = "tdist"
    with pytest.raises(ValueError, match=match):
        tfused.fused_gn_level(I[0], D[0], t6[:3], INTR, torch.zeros(6), 0.3, 5.0, 1, 0.0, 1.0, **kw)
