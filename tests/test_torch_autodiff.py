"""The trust-region ("ceres") backend as a whole: phovo_tpu_torch's
align_autodiff, align_sequence_autodiff, align_sequence_chunk_autodiff and
PhotoconsistencyOdometryAutodiff against phovo_tpu's on the CPU, on the
same numpy frames (a seeded 60x80 make_sequence chain, 5 frames, 3
pyramid levels).

phovo_tpu runs its exact per-pair XLA route on the CPU (align_autodiff:
gather linearization, trust_region_level; sequences through
sequence_scan), and its level-major route through the batched TPU kernel
in interpret mode. The port runs the trust-region kernel's plain version:
one launch a level per pair (per-pair and warm start) or per chunk (zero
init, level-major).

Tolerances: states 2e-4 absolute, cost 1e-4 relative, iterations equal,
valid counts within 0.5. The schedules use trust-region tolerances far
from their boundaries (phovo_tpu's tests/test_autodiff_modes.py), so every
active level runs its whole iteration budget in every implementation:
|dcost| <= ftol cost on float32 sums taken in different orders can
otherwise flip by one iteration. Every pair starts from zero, where the
first column's pixels warp onto the bilinear in-bounds edge u = 0 (and the
first row's onto v = 0), and phovo_tpu's XLA-compiled batch form and
torch's round them to opposite sides (tests/test_torch_trust_region.py).
The first steps then differ, and the plane scene's nearly degenerate
directions keep part of that difference to the end (phovo_tpu holds its
own level-major route to its scan within 3e-3 for that reason,
tests/test_autodiff_modes.py:101). So the frames carry no depth on a
border wide enough that those pixels are invalid at every level; one test
holds the zero-init route to phovo_tpu's scan on the same chain with depth
to the border.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phovo_tpu.models import autodiff as jad
from phovo_tpu.ops.camera import Intrinsics as JIntrinsics
from phovo_tpu.utils.config import PhovoConfig as JaxConfig
from phovo_tpu_torch.models import BACKENDS
from phovo_tpu_torch.models import autodiff as tad
from phovo_tpu_torch.ops import fused_batch as FB
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.utils.config import PhovoConfig
from phovo_tpu_torch.utils.synthetic import make_sequence

torch.set_num_threads(1)

SHAPE = (60, 80)
N_FRAMES = 5
DEPTH_SCALE = 1.0 / 5000.0  # TUM 16-bit depth counts
INTR = Intrinsics(80.0, 80.0, 39.5, 29.5)
JINTR = JIntrinsics(*(np.float32(v) for v in INTR))
# depth-less border, in full-resolution pixels: wide enough that every
# pyramid level's first row and column are invalid (see the module
# docstring)
BORDER = 4


def _config(max_iterations, sampling):
    return JaxConfig(
        num_levels=3, blur_filter_sizes=(0, 0, 0), gradient_scales=(0.0625,) * 3,
        max_iterations=max_iterations, lambda_steps=(1.0,) * 3,
        min_gradient_norms=(300.0,) * 3, function_tolerances=(1e-9,) * 3, gradient_tolerances=(1e-12,) * 3,
        parameter_tolerances=(1e-10,) * 3, initial_trust_region_radii=(1e4,) * 3,
        max_trust_region_radii=(1e8,) * 3, min_trust_region_radii=(1e-32,) * 3,
        min_relative_decreases=(1e-3,) * 3, sampling=sampling, mix_mode="f32",
    )


# The finest and coarsest levels active and the middle one skipped (zero
# diagnostics, state passed through); sampling left at 'nearest' and
# gradient_at at 'esm', which both backends override (always bilinear, the
# gradient at the warped point).
CONFIG = _config((6, 0, 8), "nearest")
CONFIG = dataclasses.replace(CONFIG, gradient_at="esm")


def _port_config(**kw):
    cfg = PhovoConfig.from_dict(dataclasses.asdict(CONFIG))
    return dataclasses.replace(cfg, **kw)


def _chain():
    I, D, _, _ = make_sequence(INTR, SHAPE, N_FRAMES, motion_scale=2.0, seed=3)
    return np.stack(I), np.stack(D)


@pytest.fixture(scope="module")
def frames():
    I, D = _chain()
    D[:, :BORDER], D[:, -BORDER:], D[:, :, :BORDER], D[:, :, -BORDER:] = 0, 0, 0, 0
    I8 = np.round(I * 255.0).astype(np.uint8)
    D16 = np.round(D / DEPTH_SCALE).astype(np.uint16)
    return dict(I=I, D=D, I8=I8, D16=D16)


@pytest.fixture(scope="module")
def jax_runs(frames):
    """phovo_tpu's results: its CPU route of align_sequence_autodiff (the
    per-pair scan of align_autodiff) from zero and warm started, its
    level-major route through the batched kernel in interpret mode, and
    its chunked entry on storage dtypes."""
    I, D = jnp.asarray(frames["I"]), jnp.asarray(frames["D"])
    chunk, ci, cd = jad.align_sequence_chunk_autodiff(
        jnp.asarray(frames["I8"][0]), jnp.asarray(frames["D"][0]),
        jnp.asarray(frames["I8"][1:]), jnp.asarray(frames["D16"][1:]),
        JINTR, CONFIG, depth_scale=DEPTH_SCALE,
    )
    return jax.device_get(dict(
        scan=jad.align_sequence_autodiff(I, D, JINTR, CONFIG),
        warm=jad.align_sequence_autodiff(I, D, JINTR, CONFIG, warm_start=True),
        levelmajor=jad.align_sequence_autodiff_levelmajor(I, D, JINTR, CONFIG, interpret=True),
        chunk=chunk, carry=(ci, cd),
    ))


def _assert_results_match(port, ref):
    np.testing.assert_allclose(port.state.numpy(), ref.state, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(port.iterations.numpy(), ref.iterations)
    np.testing.assert_allclose(port.num_valid.numpy(), ref.num_valid, rtol=0, atol=0.5)
    np.testing.assert_allclose(port.cost.numpy(), ref.cost, rtol=1e-4)
    assert float(port.band_masked.abs().sum()) == 0.0
    assert np.all(np.asarray(ref.band_masked) == 0)


def _seq(frames):
    return torch.from_numpy(frames["I"]), torch.from_numpy(frames["D"])


def test_align_autodiff_matches_jax_per_pair(frames, jax_runs):
    """Each pair alone through the port's per-pair route (one launch a
    level, B = 1) against phovo_tpu's align_autodiff on its XLA route (the
    rows of its zero-init scan); the skipped level reports zeros."""
    I, D = _seq(frames)
    ref = jax_runs["scan"]
    for k in range(N_FRAMES - 1):
        port = tad.align_autodiff(I[k], D[k], I[k + 1], D[k + 1], INTR, torch.zeros(6), _port_config())
        _assert_results_match(port, type(ref)(*(np.asarray(x)[k] for x in ref)))
        assert int(port.iterations[1]) == 0
        assert float(port.cost[1]) == float(port.gradient_norm[1]) == float(port.num_valid[1]) == 0.0


@pytest.mark.parametrize("warm", [False, True], ids=["zero-init", "warm-start"])
def test_align_sequence_autodiff_matches_jax(frames, jax_runs, warm):
    """Zero init takes the port's level-major route, warm start its serial
    chain; phovo_tpu runs its per-pair scan for both on the CPU."""
    I, D = _seq(frames)
    before = FB.TR_LAUNCHES
    port = tad.align_sequence_autodiff(I, D, INTR, _port_config(), warm_start=warm)
    assert FB.TR_LAUNCHES == before  # CPU tensors: the plain version
    _assert_results_match(port, jax_runs["warm" if warm else "scan"])
    assert np.all(port.iterations[:, 1].numpy() == 0)
    if warm:  # the chain really warm-started: pair k began at pair k-1's end
        zero = tad.align_sequence_autodiff(I, D, INTR, _port_config())
        assert not torch.equal(port.state, zero.state)


def test_levelmajor_matches_jax_levelmajor_kernel(frames, jax_runs):
    """The level-major route against phovo_tpu's level-major route through
    its batched TPU kernel (B2) in interpret mode, which preps the 'esm'
    config as 'warped' (its regression tests/test_autodiff_modes.py:70)."""
    I, D = _seq(frames)
    port = tad.align_sequence_autodiff(I, D, INTR, _port_config())
    _assert_results_match(port, jax_runs["levelmajor"])


def test_levelmajor_matches_jax_scan_on_ordinary_frames():
    """The zero-init level-major route on the chain with depth to the
    border, where the first column warps onto u = 0 at the zero state,
    against phovo_tpu's per-pair scan on its CPU route."""
    I, D = _chain()
    ref = jax.device_get(jad.align_sequence_autodiff(jnp.asarray(I), jnp.asarray(D), JINTR, CONFIG))
    port = tad.align_sequence_autodiff(torch.from_numpy(I), torch.from_numpy(D), INTR, _port_config())
    _assert_results_match(port, ref)


def test_align_sequence_chunk_autodiff_matches_jax(frames, jax_runs):
    """Storage dtypes (uint8 intensity, uint16 depth counts) converted on
    the device, the carry frame prepended there; carries equal bit for
    bit."""
    res, ci, cd = tad.align_sequence_chunk_autodiff(
        torch.from_numpy(frames["I8"][0]), torch.from_numpy(frames["D"][0]),
        torch.from_numpy(frames["I8"][1:]), torch.from_numpy(frames["D16"][1:]),
        INTR, _port_config(), depth_scale=DEPTH_SCALE,
    )
    _assert_results_match(res, jax_runs["chunk"])
    jci, jcd = jax_runs["carry"]
    np.testing.assert_array_equal(ci.numpy(), jci)
    np.testing.assert_array_equal(cd.numpy(), jcd)


def test_object_api_matches_functional(frames, jax_runs):
    """PhotoconsistencyOdometryAutodiff (the reference's 7-method class,
    under both of its BACKENDS names) gives align_autodiff's result, from
    numpy frames in storage dtypes and from tensors."""
    assert BACKENDS["ceres"] is BACKENDS["autodiff"] is tad.PhotoconsistencyOdometryAutodiff
    vo = BACKENDS["ceres"](_port_config(), device="cpu")
    assert vo.COST_IS_HALF_SUM_SQ
    with pytest.raises(RuntimeError, match="set_intrinsic_matrix"):
        vo.optimize()
    vo.set_intrinsic_matrix(np.array([[80.0, 0, 39.5], [0, 80.0, 29.5], [0, 0, 1]]))
    with pytest.raises(RuntimeError, match="frames must be set"):
        vo.optimize()
    with pytest.raises(RuntimeError, match="optimize"):
        vo.get_optimal_state_vector()
    vo.set_min_depth(0.3)
    vo.set_max_depth(5.0)
    # pair 1 of the chunk run: uint8 intensity, depth from uint16 counts
    depth = [frames["D16"][k].astype(np.float32) * np.float32(DEPTH_SCALE) for k in (1, 2)]
    vo.set_source_frame(frames["I8"][1], depth[0].astype(np.float64))
    vo.set_target_frame(torch.from_numpy(frames["I8"][2]), torch.from_numpy(depth[1]))
    vo.set_initial_state_vector(np.zeros(6))
    res = vo.optimize()
    ref = jax_runs["chunk"]
    _assert_results_match(res, type(ref)(*(np.asarray(x)[1] for x in ref)))
    assert torch.equal(vo.get_optimal_state_vector(), res.state)
    T = vo.get_optimal_rigid_transformation_matrix()
    assert T.shape == (4, 4) and torch.equal(T[3], torch.tensor([0.0, 0.0, 0.0, 1.0]))


def test_warm_start_runs_one_launch_per_pair_per_level(frames, monkeypatch):
    """The warm-started chain is per-pair: one level call per pair per
    active level, each at B = 1 and starting from the last pair's state."""
    calls = []
    real = tad.fused_tr_level_batch

    def spy(i0, geom, t_all, intr, init, *args, **kw):
        assert init.shape == (1, 6) and t_all.shape[0] == 1
        calls.append(init[0].clone())
        return real(i0, geom, t_all, intr, init, *args, **kw)

    monkeypatch.setattr(tad, "fused_tr_level_batch", spy)
    I, D = _seq(frames)
    cfg = _port_config()
    res = tad.align_sequence_autodiff(I, D, INTR, cfg, warm_start=True)
    active = sum(n > 0 for n in cfg.max_iterations)
    assert len(calls) == active * (N_FRAMES - 1)
    for k in range(1, N_FRAMES - 1):  # each pair's coarsest level starts warm
        assert torch.equal(calls[k * active], res.state[k - 1])


def test_sampling_is_always_bilinear_and_gradient_at_is_ignored(frames):
    """align_autodiff samples bilinear whatever config.sampling says, and
    does not read gradient_at ('esm' is prepped with the warped-gradient
    pack), on both routes."""
    I, D = _seq(frames)
    base = _port_config(sampling="bilinear", gradient_at="warped")
    for kw in (dict(sampling="nearest"), dict(gradient_at="esm"), dict(gradient_at="source")):
        cfg = dataclasses.replace(base, **kw)
        for warm in (False, True):
            a = tad.align_sequence_autodiff(I, D, INTR, cfg, warm_start=warm)
            b = tad.align_sequence_autodiff(I, D, INTR, base, warm_start=warm)
            for x, y in zip(a, b):
                assert torch.equal(x, y), kw


def test_tdist_raises_value_error_like_jax(frames):
    I, D = _seq(frames)
    cfg = _port_config(robust_loss="tdist")
    jcfg = dataclasses.replace(CONFIG, robust_loss="tdist")
    with pytest.raises(ValueError, match="tdist") as port_err:
        tad.align_autodiff(I[0], D[0], I[1], D[1], INTR, torch.zeros(6), cfg)
    with pytest.raises(ValueError, match="tdist") as jax_err:
        jad.align_autodiff(
            jnp.asarray(frames["I"][0]), jnp.asarray(frames["D"][0]),
            jnp.asarray(frames["I"][1]), jnp.asarray(frames["D"][1]),
            JINTR, jnp.zeros(6), jcfg,
        )
    assert str(port_err.value) == str(jax_err.value)
    for warm in (False, True):
        with pytest.raises(ValueError, match="tdist"):
            tad.align_sequence_autodiff(I, D, INTR, cfg, warm_start=warm)
        with pytest.raises(ValueError, match="tdist"):
            tad.align_sequence_chunk_autodiff(I[0], D[0], I[1:], D[1:], INTR, cfg, warm_start=warm)
