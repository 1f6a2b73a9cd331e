"""The inverse-compositional backend: phovo_tpu_torch's IC kernels' plain
versions, its exact path, align_ic, align_sequence_ic,
align_sequence_chunk_ic and PhotoconsistencyOdometryIC against phovo_tpu's
on the CPU, on the same numpy frames.

Kernel level, on make_sequence frames at 30x40 and 48x64, where phovo_tpu's
IC kernel samples the whole target (its banded row window starts above
H = 48, phovo_tpu/ops/ic.py:235, so its band_masked must read 0 here):
  * K-ICpre's plain version against ic_precompute_pallas in interpret mode:
    J8 within 1e-6 (the same expressions; XLA rounds some products of the
    rows an ulp apart, 4.8e-7 at most), L within 1e-4 of max|L| (the Gram's
    pixel sums in another order);
  * K-IC's plain version at B = 1 against ic_gn_level and at B = 3 against
    ic_gn_level_batch (interpret, 2 pairs a grid step, so one pad pair),
    nearest over 3 iterations, bilinear over 8, and an early-exit case
    whose threshold lies at least 7% from every ||g|| read before a stop:
    poses within 5e-5 (tests/test_ic.py:74's level; the TPU kernel samples
    through one-hot matrix products, so sums differ in order), equal
    iteration and valid counts.
The exact path against phovo_tpu's XLA form: ic_precompute at 96x128 and
its two coarser levels (J8 within 1e-5, L within 2e-4 of max|L|,
tests/test_ic.py:103-123), ic_gn_level_exact against ic_gn_level_xla.

Backend level, a 4-frame make_sequence chain at 96x128, 3 levels, depth
zero on an 8-pixel border (from the zero state a border pixel warps onto
the bilinear edge u = 0, which the two forms round to opposite sides;
tests/test_torch_analytic.py): phovo_tpu on the CPU runs its XLA route,
the port its kernels' plain versions (or, with use_fused=False, its exact
path). Bilinear runs 3, 4 and 6 iterations a level, nearest one (see
VARIANTS). Poses within 5e-5 a level (1.5e-4 over the 3 levels), costs
within 1e-4 relative, iteration and valid counts equal.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phovo_tpu.models import ic as jic_models
from phovo_tpu.ops import ic as jic
from phovo_tpu.ops import ic_batch as jicb
from phovo_tpu.ops.camera import Intrinsics as JIntrinsics
from phovo_tpu.ops.fused import _ceil8, _pick_tile_pixels
from phovo_tpu.utils.config import PhovoConfig as JaxConfig
import phovo_tpu_torch
from phovo_tpu_torch.models import BACKENDS
from phovo_tpu_torch.models import ic as tic
from phovo_tpu_torch.ops import ic as ic_ops
from phovo_tpu_torch.ops import ic_batch as ICB
from phovo_tpu_torch.ops import pyramid as pyr
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.fused import pack_geometry
from phovo_tpu_torch.utils.config import PhovoConfig
from phovo_tpu_torch.utils.synthetic import make_sequence

torch.set_num_threads(1)

SHAPE = (96, 128)
N_FRAMES = 4
INTR = Intrinsics(128.0, 128.0, 63.5, 47.5)
JINTR = JIntrinsics(*(np.float32(v) for v in INTR))
DEPTH_SCALE = 1.0 / 5000.0
SCALE = 0.03125  # the true Scharr derivative (models/ic.py)
POSE_ATOL = 5e-5  # a level (tests/test_ic.py:74)

BASE = JaxConfig(
    num_levels=3, blur_filter_sizes=(0,) * 3, gradient_scales=(SCALE,) * 3,
    max_iterations=(3, 4, 6), lambda_steps=(1.0,) * 3, min_gradient_norms=(0.0,) * 3,
    sampling="bilinear", mix_mode="f32",
)
# Nearest runs one iteration a level: the cost of a second nearest
# linearization moves by whole samples that flip between states 1e-5
# apart (1.8e-4 relative on the exact path, 5.6e-4 on the chunk's depth
# counts at 96x128, against 7.7e-7 after one).
VARIANTS = {
    "bilinear": {},
    "nearest": dict(sampling="nearest", max_iterations=(1, 1, 1)),
}


def _jcfg(name):
    return dataclasses.replace(BASE, **VARIANTS[name])


def _tcfg(name):
    return PhovoConfig.from_dict(dataclasses.asdict(_jcfg(name)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax(x):
    return jax.tree.map(np.asarray, jax.device_get(x))


def _chip_smoke():
    """chip_smoke.py as a module (it runs its phases only as a script)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# -- the kernels' plain versions at the level, H <= 48 --------------------------

LEVEL_SHAPES = [(30, 40), (48, 64)]


def _level_frames(H, W, n=4):
    """n make_sequence frames at H x W with intrinsics matched to the size
    and a 2-pixel depth-less border, their K-ICpre products (plain version)
    and pack_geometry rows. From the identity, column 0 warps onto the
    bilinear edge u = 0, which the two forms round to opposite sides: with
    depth there, the first ||g|| differs by 0.8% at 30x40 and a one-step
    early exit leaves poses 1.3e-3 apart."""
    intr = Intrinsics(float(W), float(W), (W - 1) / 2, (H - 1) / 2)
    I, D, _, _ = make_sequence(intr, (H, W), n, seed=2)
    D = np.stack(D)
    for edge in (np.s_[:, :2], np.s_[:, -2:], np.s_[:, :, :2], np.s_[:, :, -2:]):
        D[edge] = 0.0
    It, Dt = _t(np.stack(I)), _t(D)
    gx, gy = pyr.scharr(It, "x", SCALE), pyr.scharr(It, "y", SCALE)
    J8, L = ic_ops.ic_precompute_batch(It, Dt, gx, gy, intr, 0.3, 5.0)
    return dict(intr=intr, I=It, D=Dt, gx=gx, gy=gy, J8=J8, L=L, geom=pack_geometry(Dt, intr, 0.3, 5.0))


@pytest.fixture(scope="module", params=LEVEL_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def level(request):
    return _level_frames(*request.param)


def test_precompute_plain_matches_pallas_kernel(level):
    """K-ICpre's plain version, all frames in one call, against phovo_tpu's
    kernel in interpret mode, one frame at a time."""
    jintr = JIntrinsics(*(np.float32(v) for v in level["intr"]))
    H, W = level["I"].shape[1:]
    for f in range(2):
        args = (level[k][f].numpy() for k in ("I", "D", "gx", "gy"))
        jJ8, jL = jic.ic_precompute_pallas(*map(jnp.asarray, args), jintr, 0.3, 5.0, interpret=True)
        jJ8, jL = np.asarray(jJ8), np.asarray(jL)[0]
        np.testing.assert_allclose(level["J8"][f].numpy(), jJ8[:, :H * W], rtol=0, atol=1e-6)
        np.testing.assert_allclose(level["L"][f].numpy(), jL, rtol=0, atol=1e-4 * np.abs(jL).max())
        assert np.all(jL.reshape(6, 6)[np.triu_indices(6, 1)] == 0.0)
        assert np.all(level["L"][f].numpy().reshape(6, 6)[np.triu_indices(6, 1)] == 0.0)


def _pad_lanes(a, NP):
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, NP - a.shape[-1])])


def _jax_level(level, sampling, n, threshold, pairs):
    """phovo_tpu's IC level kernel in interpret mode on the same inputs:
    pairs == 1 through ic_gn_level, else ic_gn_level_batch with 2 pairs a
    grid step. Returns (T, iterations, gnorm, cost, nvalid, band_masked)
    as numpy with a leading pair dim."""
    jintr = JIntrinsics(*(np.float32(v) for v in level["intr"]))
    H, W = level["I"].shape[1:]
    J8, L = level["J8"].numpy(), level["L"].numpy()
    if pairs == 1:
        out = jic.ic_gn_level(
            jnp.eye(4), jnp.asarray(level["D"][0].numpy()), jnp.asarray(J8[0]),
            jnp.asarray(L[0].reshape(6, 6)), jnp.asarray(level["I"][1].numpy()), jintr,
            n, threshold, 1.0, sampling, interpret=True,
        )
        return [np.asarray(x)[None] for x in out]
    NP, _ = _pick_tile_pixels(H, W)
    tgt = np.pad(level["I"][1:pairs + 1].numpy(), [(0, 0), (0, _ceil8(H) - H), (0, 0)])
    out = jicb.ic_gn_level_batch(
        jnp.tile(jnp.eye(4), (pairs, 1, 1)), jnp.asarray(_pad_lanes(level["geom"][:pairs, :3].numpy(), NP)),
        jnp.asarray(_pad_lanes(J8[:pairs], NP)), jnp.asarray(L[:pairs]), jnp.asarray(tgt), jintr,
        n, threshold, 1.0, H=H, W=W, sampling=sampling, interpret=True, streams=2,
    )
    return [np.asarray(x) for x in out]


def _port_level(level, sampling, n, threshold, pairs):
    H, W = level["I"].shape[1:]
    return ICB.ic_gn_level_batch(
        torch.eye(4).repeat(pairs, 1, 1), level["geom"][:pairs], level["J8"][:pairs],
        level["L"][:pairs], level["I"][1:pairs + 1], level["intr"], n, threshold, 1.0,
        H=H, W=W, sampling=sampling,
    )


def _assert_level_match(port, ref):
    np.testing.assert_allclose(port.T.numpy(), ref[0], rtol=0, atol=POSE_ATOL)
    np.testing.assert_array_equal(port.iterations.numpy(), ref[1])
    np.testing.assert_array_equal(port.num_valid.numpy(), ref[4])
    np.testing.assert_allclose(port.cost.numpy(), ref[3], rtol=1e-4)
    np.testing.assert_array_equal(ref[5], 0.0)  # no band at H <= 48
    assert float(port.band_masked.abs().sum()) == 0.0


@pytest.mark.parametrize("pairs", [1, 3], ids=["per-pair", "batch"])
@pytest.mark.parametrize("sampling,n", [("nearest", 3), ("bilinear", 8)])
def test_level_plain_matches_pallas_kernel(level, sampling, n, pairs):
    """K-IC's plain version against phovo_tpu's per-pair kernel (B9) and
    its batched kernel (B10) in interpret mode, from the identity."""
    port = _port_level(level, sampling, n, 0.0, pairs)
    _assert_level_match(port, _jax_level(level, sampling, n, 0.0, pairs))
    if pairs == 1:  # ops/ic.ic_gn_level: the same plain version at B = 1
        one = ic_ops.ic_gn_level(torch.eye(4), level["geom"][0], level["J8"][0], level["L"][0],
                                 level["I"][1], level["intr"], n, 0.0, 1.0, sampling)
        assert torch.equal(one[0], port.T[0]) and int(one[1]) == int(port.iterations[0])


def _gnorm_values(level, sampling, n, pairs):
    """(n + 1, pairs) float64: the ||g|| the stopping test reads after 0..n
    iterations of the plain version (inf before the first)."""
    rows = [torch.full((pairs,), float("inf"), dtype=torch.float64)]
    rows += [_port_level(level, sampling, k, 0.0, pairs).gradient_norm.double() for k in range(1, n + 1)]
    return torch.stack(rows)


@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
def test_level_early_exit_matches_pallas_kernel(level, sampling):
    """A threshold set at least 7% from every ||g|| read before a stop
    (chip_smoke.early_exit_tolerance): the plain version and phovo_tpu's
    batched kernel stop every pair after the predicted count."""
    smoke = _chip_smoke()
    n, pairs = 3, 3
    tol, stops = smoke.early_exit_tolerance(_gnorm_values(level, sampling, n, pairs))
    port = _port_level(level, sampling, n, tol, pairs)
    assert port.iterations.tolist() == stops.tolist()
    _assert_level_match(port, _jax_level(level, sampling, n, tol, pairs))


def test_exact_precompute_matches_jax():
    """ic_precompute against phovo_tpu's XLA form at 96x128, 48x64 and
    24x32 of one frame; and K-ICpre's plain version against it."""
    I, D, _, _ = make_sequence(INTR, SHAPE, 2, seed=2)
    It, Dt = pyr.build_pyramid(_t(I[0]), 3), pyr.build_pyramid(_t(D[0]), 3)
    for lv in range(3):
        intr = INTR.at_level(lv)
        gx, gy = pyr.scharr(It[lv], "x", SCALE), pyr.scharr(It[lv], "y", SCALE)
        J8, L = ic_ops.ic_precompute(It[lv], Dt[lv], gx, gy, intr, 0.3, 5.0)
        jJ8, jL = jic.ic_precompute(
            *(jnp.asarray(x.numpy()) for x in (It[lv], Dt[lv], gx, gy)),
            JIntrinsics(*(np.float32(v) for v in intr)), 0.3, 5.0,
        )
        jL = np.asarray(jL)
        np.testing.assert_allclose(J8.numpy(), np.asarray(jJ8), rtol=0, atol=1e-5)
        np.testing.assert_allclose(L.numpy(), jL, rtol=0, atol=2e-4 * np.abs(jL).max())
        kJ8, kL = ic_ops.ic_precompute_batch(*(x[None].contiguous() for x in (It[lv], Dt[lv], gx, gy)),
                                             intr, 0.3, 5.0)
        np.testing.assert_allclose(kJ8[0].numpy(), np.asarray(jJ8), rtol=0, atol=1e-5)
        np.testing.assert_allclose(kL[0].numpy().reshape(6, 6), jL, rtol=0, atol=2e-4 * np.abs(jL).max())


@pytest.mark.parametrize("sampling,n", [("nearest", 3), ("bilinear", 8)])
def test_exact_level_matches_jax(level, sampling, n):
    """ic_gn_level_exact against phovo_tpu's ic_gn_level_xla on the same
    J8 and factor; and against K-IC's plain version."""
    J8, L = level["J8"][0], level["L"][0].reshape(6, 6)
    args = (level["D"][0], J8, L, level["I"][1])
    port = ic_ops.ic_gn_level_exact(torch.eye(4), *args, level["intr"], n, 0.0, 1.0, sampling)
    ref = jic.ic_gn_level_xla(
        jnp.eye(4), *(jnp.asarray(x.numpy()) for x in args),
        JIntrinsics(*(np.float32(v) for v in level["intr"])), n, 0.0, 1.0, sampling,
    )
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]), rtol=0, atol=POSE_ATOL)
    assert int(port[1]) == int(ref[1]) == n
    assert float(port[4]) == float(ref[4])
    np.testing.assert_allclose(float(port[3]), float(ref[3]), rtol=1e-4)
    plain = _port_level(level, sampling, n, 0.0, 1)
    np.testing.assert_allclose(port[0].numpy(), plain.T[0].numpy(), rtol=0, atol=POSE_ATOL)
    assert float(port[4]) == float(plain.num_valid[0])


# -- the backend against phovo_tpu's on a 96x128 chain ---------------------------


@pytest.fixture(scope="module")
def frames():
    I, D, _, _ = make_sequence(INTR, SHAPE, N_FRAMES, seed=2)
    I, D = np.stack(I), np.stack(D)
    for edge in (np.s_[:, :8], np.s_[:, -8:], np.s_[:, :, :8], np.s_[:, :, -8:]):
        D[edge] = 0.0
    I8 = np.round(I * 255.0).astype(np.uint8)
    D16 = np.round(D / DEPTH_SCALE).astype(np.uint16)
    return dict(I=I, D=D, I8=I8, D16=D16)


@pytest.fixture(scope="module")
def jax_scans(frames):
    """phovo_tpu's align_sequence_ic from zero (a scan of align_ic, its XLA
    route on the CPU) per variant, on uint8 frames."""
    return {
        name: _jax(jic_models.align_sequence_ic(frames["I8"], frames["D"], JINTR, _jcfg(name)))
        for name in VARIANTS
    }


def _assert_match(port, ref, levels=3):
    np.testing.assert_allclose(port.state.numpy(), ref.state, rtol=0, atol=POSE_ATOL * levels)
    np.testing.assert_array_equal(port.iterations.numpy(), ref.iterations)
    np.testing.assert_array_equal(port.num_valid.numpy(), ref.num_valid)
    np.testing.assert_allclose(port.cost.numpy(), ref.cost, rtol=1e-4)
    assert float(port.band_masked.abs().sum()) == 0.0


@pytest.mark.parametrize("use_fused", [True, False], ids=["kernels", "exact"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_align_ic_matches_jax(frames, jax_scans, name, use_fused):
    """Per pair: K-ICpre and K-IC at B = 1 per active level (their plain
    versions here), or the exact path."""
    port = [
        tic.align_ic(
            _t(frames["I8"][k]), _t(frames["D"][k]), _t(frames["I8"][k + 1]),
            _t(frames["D"][k + 1]), INTR, torch.zeros(6), _tcfg(name), use_fused,
        )
        for k in range(N_FRAMES - 1)
    ]
    _assert_match(tic.AlignmentResult(*(torch.stack(x) for x in zip(*port))), jax_scans[name])


@pytest.mark.parametrize("name", list(VARIANTS))
def test_align_sequence_ic_matches_jax(frames, jax_scans, name):
    """The zero-init chain, level-major: one K-ICpre launch per level for
    all frames, one K-IC launch per level for all pairs."""
    port = tic.align_sequence_ic(_t(frames["I8"]), _t(frames["D"]), INTR, _tcfg(name))
    _assert_match(port, jax_scans[name])
    exact = tic.align_sequence_ic(_t(frames["I8"]), _t(frames["D"]), INTR, _tcfg(name), use_fused=False)
    _assert_match(exact, jax_scans[name])


def test_warm_started_sequence_matches_jax(frames):
    """warm_start: the serial chain of align_ic, each pair from the state
    the one before ended at."""
    ref = _jax(jic_models.align_sequence_ic(frames["I"], frames["D"], JINTR, _jcfg("bilinear"), warm_start=True))
    port = tic.align_sequence_ic(_t(frames["I"]), _t(frames["D"]), INTR, _tcfg("bilinear"), warm_start=True)
    _assert_match(port, ref)
    zero = tic.align_sequence_ic(_t(frames["I"]), _t(frames["D"]), INTR, _tcfg("bilinear"))
    assert not torch.equal(port.state[1:], zero.state[1:])


def test_align_sequence_chunk_ic_matches_jax(frames):
    """Storage dtypes (uint8 intensity, uint16 depth counts times
    depth_scale) converted on the device, the carry frame prepended there."""
    args = (frames["I8"][0], frames["D"][0], frames["I8"][1:], frames["D16"][1:])
    ref, jci, jcd = jic_models.align_sequence_chunk_ic(
        *args, JINTR, _jcfg("nearest"), depth_scale=DEPTH_SCALE,
    )
    port, ci, cd = tic.align_sequence_chunk_ic(*map(_t, args), INTR, _tcfg("nearest"), depth_scale=DEPTH_SCALE)
    _assert_match(port, _jax(ref))
    np.testing.assert_array_equal(ci.numpy(), np.asarray(jci))
    np.testing.assert_array_equal(cd.numpy(), np.asarray(jcd))


def test_object_api_matches_jax(frames):
    """The reference's object interface over align_ic, and its exact-path
    re-run (align_full_band)."""
    K = [[INTR.fx, 0.0, INTR.cx], [0.0, INTR.fy, INTR.cy], [0.0, 0.0, 1.0]]
    init = np.array([0.002, -0.001, 0.003, 0.001, 0.0, -0.002], np.float32)
    out = []
    for make in (lambda: jic_models.PhotoconsistencyOdometryIC(_jcfg("bilinear")),
                 lambda: BACKENDS["ic"](_tcfg("bilinear"), device="cpu")):
        vo = make()
        vo.set_intrinsic_matrix(np.asarray(K))
        vo.set_source_frame(frames["I8"][0], frames["D"][0])
        vo.set_target_frame(frames["I8"][1], frames["D"][1])
        vo.set_initial_state_vector(init)
        res = vo.optimize()
        out.append((np.asarray(vo.get_optimal_state_vector()),
                    np.asarray(vo.get_optimal_rigid_transformation_matrix()), res, vo))
    (js, jT, jres, _), (ts, tT, tres, tvo) = out
    np.testing.assert_allclose(ts, js, rtol=0, atol=3 * POSE_ATOL)
    np.testing.assert_allclose(tT, jT, rtol=0, atol=3 * POSE_ATOL)
    np.testing.assert_array_equal(tres.iterations.numpy(), np.asarray(jres.iterations))
    full = tvo.align_full_band(*tvo._source, *tvo._target, tvo.intrinsics, tvo._init_state)
    np.testing.assert_allclose(full.state.numpy(), ts, rtol=0, atol=3 * POSE_ATOL)


# -- the rest --------------------------------------------------------------------


@pytest.mark.parametrize("loss", ["huber", "cauchy", "tukey", "tdist"])
def test_robust_losses_raise(frames, loss):
    """IC's factor is precomputed from the source frame: every entry point
    refuses a robust loss, with phovo_tpu's ValueError."""
    cfg = dataclasses.replace(_tcfg("bilinear"), robust_loss=loss)
    I, D = _t(frames["I"]), _t(frames["D"])
    calls = [
        lambda: tic.align_ic(I[0], D[0], I[1], D[1], INTR, torch.zeros(6), cfg),
        lambda: tic.align_ic(I[0], D[0], I[1], D[1], INTR, torch.zeros(6), cfg, use_fused=False),
        lambda: tic.align_sequence_ic(I, D, INTR, cfg),
        lambda: tic.align_sequence_ic(I, D, INTR, cfg, warm_start=True),
        lambda: tic.align_sequence_chunk_ic(I[0], D[0], I[1:], D[1:], INTR, cfg),
        lambda: tic.PhotoconsistencyOdometryIC(cfg, device="cpu").align(I[0], D[0], I[1], D[1], INTR, torch.zeros(6)),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="robust_loss"):
            call()
    with pytest.raises(ValueError, match="robust_loss"):
        jic_models.align_ic(frames["I"][0], frames["D"][0], frames["I"][1], frames["D"][1],
                            JINTR, jnp.zeros(6), dataclasses.replace(_jcfg("bilinear"), robust_loss=loss))


@pytest.mark.parametrize("use_fused", [True, False], ids=["kernels", "exact"])
def test_skipped_levels_pass_the_state_through(frames, use_fused):
    """max_iterations 0 everywhere: the initial state comes back (through
    pose_matrix and matrix_to_state, 1e-5) with zero diagnostics."""
    cfg = dataclasses.replace(_tcfg("bilinear"), max_iterations=(0, 0, 0))
    init = torch.tensor([0.01, -0.02, 0.005, 0.003, -0.001, 0.002])
    res = tic.align_ic(_t(frames["I"][0]), _t(frames["D"][0]), _t(frames["I"][1]),
                       _t(frames["D"][1]), INTR, init, cfg, use_fused)
    np.testing.assert_allclose(res.state.numpy(), init.numpy(), rtol=0, atol=1e-5)
    assert int(res.iterations.sum()) == 0 and float(res.num_valid.abs().sum()) == 0.0
    # one level skipped in the middle of a chain: the others still run
    cfg = dataclasses.replace(_tcfg("bilinear"), max_iterations=(2, 0, 2))
    seq = tic.align_sequence_ic(_t(frames["I"]), _t(frames["D"]), INTR, cfg)
    assert seq.iterations[:, 1].tolist() == [0] * (N_FRAMES - 1)
    assert seq.iterations[:, 0].tolist() == seq.iterations[:, 2].tolist() == [2] * (N_FRAMES - 1)


def test_backends_and_exports():
    assert BACKENDS["ic"] is tic.PhotoconsistencyOdometryIC
    for name in ("align_ic", "align_sequence_ic", "align_sequence_chunk_ic", "PhotoconsistencyOdometryIC"):
        assert getattr(phovo_tpu_torch, name) is getattr(tic, name)


def test_cpu_routes_launch_nothing(frames):
    """On CPU tensors every IC entry point runs the plain versions."""
    before = (ic_ops.IC_PRE_LAUNCHES, ICB.IC_LAUNCHES)
    I, D = _t(frames["I"]), _t(frames["D"])
    tic.align_sequence_ic(I, D, INTR, _tcfg("nearest"))
    tic.align_ic(I[0], D[0], I[1], D[1], INTR, torch.zeros(6), _tcfg("nearest"))
    assert (ic_ops.IC_PRE_LAUNCHES, ICB.IC_LAUNCHES) == before
