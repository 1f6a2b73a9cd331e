"""The level kernel's plain version (fused_gn_level_batch_reference) held
to phovo_tpu on the CPU.

Two references, both on the same numpy frames:
  * phovo_tpu's batched level kernel fused_gn_level_batch in interpret
    mode, exact f32 sampling, one pair per grid step. At H <= 48 its banded
    row window is the whole image, so it samples every row, like the port.
  * the exact per-pair path: gauss_newton_level over
    photometric_residual_jacobian + normal_equations.

Tolerances: states 2e-4 absolute (the level tests/test_fused_batch.py pins
for the TPU batch kernel: float32 pixel sums taken in another order, then
amplified by the 6x6 solve), cost 1e-4 relative; iterations and valid
counts equal. Init states are small seeded perturbations of zero: at
exactly zero a border pixel warps onto the bilinear in-bounds edge u = 0,
where the batch form (u = tx fx (1/z) + cx) and the exact form
(u = tx fx / z + cx) can round to opposite sides.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phovo_tpu.ops import fused as jfused
from phovo_tpu.ops import pyramid as jpyr
from phovo_tpu.ops.camera import Intrinsics as JIntrinsics
from phovo_tpu.ops.fused_batch import fused_gn_level_batch as jax_level_batch
from phovo_tpu.ops.residuals import normal_equations, photometric_residual_jacobian
from phovo_tpu.solvers.gauss_newton import gauss_newton_level
from phovo_tpu_torch.ops import fused_batch as FB
from phovo_tpu_torch.ops import pyramid as tpyr
from phovo_tpu_torch.ops import residuals as tres
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.fused import pack_geometry, pack_target
from phovo_tpu_torch.solvers.gauss_newton import gauss_newton_level as torch_gn_level
from phovo_tpu_torch.utils.synthetic import make_sequence

torch.set_num_threads(1)

B = 3
SCALE = 0.0625
# (level of the 96x128 intr fixture, shape, sampling, iterations,
# min_gradient_norm): fixed iterations, then early exit at a threshold
# that freezes the pairs at different iterations. Nearest sampling on this
# plane does not converge (||g|| wanders between 10 and 40), and each
# iteration a few pixels whose warped coordinate sits within an ulp of a
# rounding boundary sample a neighbour in one formulation and not the
# other; the exact and batch forms then drift apart after 3-4 iterations
# at 48x64 (phovo_tpu's own two paths as much as the port). The nearest
# 48x64 cases stop at 3 iterations for that reason.
CASES = [
    (2, (24, 32), "nearest", 8, 0.0),
    (2, (24, 32), "nearest", 8, 10.0),
    (2, (24, 32), "bilinear", 6, 0.0),
    (2, (24, 32), "bilinear", 8, 3.0),
    (1, (48, 64), "nearest", 3, 0.0),
    (1, (48, 64), "nearest", 3, 80.0),
    (1, (48, 64), "bilinear", 6, 0.0),
    (1, (48, 64), "bilinear", 8, 3.8),
]


def _case_id(case):
    level, shape, sampling, its, mg = case
    return f"{shape[0]}x{shape[1]}-{sampling}-{its}it-g{mg:g}"


@functools.partial(jax.jit, static_argnames=("intr", "its", "mg", "sampling"))
def _jax_exact(si, sd, ti, gx, gy, init, intr, its, mg, sampling):
    def one(si, sd, ti, gx, gy, init):
        def linearize(s):
            r, J, v = photometric_residual_jacobian(
                si, sd, ti, gx, gy, s, intr, 0.3, 5.0, sampling
            )
            return normal_equations(r, J, v)

        return gauss_newton_level(linearize, init, its, mg, 1.0)

    return jax.vmap(one)(si, sd, ti, gx, gy, init)


@pytest.fixture(scope="module")
def runs(intr):
    """Per case: the inputs (numpy), phovo_tpu's batch kernel in interpret
    mode and phovo_tpu's exact per-pair solve."""
    out = {}
    frames = {}
    for case in CASES:
        level, shape, sampling, its, mg = case
        jintr = intr.at_level(level)
        tintr = Intrinsics(*(float(v) for v in jintr))
        if shape not in frames:
            I, D, _, _ = make_sequence(tintr, shape, B + 1, motion_scale=2.0)
            I, D = np.stack(I), np.stack(D)
            gx, gy = jpyr.build_gradient_pyramid([jnp.asarray(I)], (SCALE,))
            rng = np.random.default_rng(level)
            init = (rng.standard_normal((B, 6)) * 1e-3).astype(np.float32)
            frames[shape] = (I, D, np.asarray(gx[0]), np.asarray(gy[0]), init)
        I, D, gx, gy, init = frames[shape]
        H, W = shape
        NP, _ = jfused._pick_tile_pixels(H, W)
        i0 = jnp.concatenate(
            [jfused._pad_flat(jnp.asarray(I[k]).reshape(1, H * W), NP) for k in range(B)]
        )
        geom = jnp.stack(
            [jfused.pack_geometry(jnp.asarray(D[k]), jintr, 0.3, 5.0, NP) for k in range(B)]
        )
        tstack = jnp.stack([
            jfused.pack_target_colmajor(jnp.asarray(I[k]), jnp.asarray(gx[k]), jnp.asarray(gy[k]))
            for k in range(1, B + 1)
        ])
        batch = jax_level_batch(
            i0, geom, tstack, jintr, jnp.asarray(init), 0.3, 5.0, its, mg, 1.0,
            H=H, W=W, sampling=sampling, interpret=True, mix_mode="f32", streams=1,
        )
        exact = _jax_exact(
            jnp.asarray(I[:-1]), jnp.asarray(D[:-1]), jnp.asarray(I[1:]),
            jnp.asarray(gx[1:]), jnp.asarray(gy[1:]), jnp.asarray(init),
            jintr, its, mg, sampling,
        )
        out[case] = dict(
            frames=frames[shape], intr=tintr,
            batch=[np.asarray(x) for x in batch],
            exact=[np.asarray(x) for x in exact],
        )
    return out


def _port_level(run, case, fn=FB.fused_gn_level_batch):
    level, shape, sampling, its, mg = case
    I, D, _, _, init = run["frames"]
    It, Dt = torch.from_numpy(I), torch.from_numpy(D)
    t_all = pack_target(It, tpyr.scharr(It, "x", SCALE), tpyr.scharr(It, "y", SCALE))
    return fn(
        It[:-1].reshape(B, -1).contiguous(),
        pack_geometry(Dt[:-1], run["intr"], 0.3, 5.0).contiguous(),
        t_all[1:].contiguous(), run["intr"], torch.from_numpy(init),
        its, mg, 1.0, H=shape[0], W=shape[1], sampling=sampling,
    )


def _assert_level_match(port, state, its, cost, nvalid):
    np.testing.assert_allclose(port.state.numpy(), state, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(port.iterations.numpy(), its)
    np.testing.assert_array_equal(port.num_valid.numpy(), nvalid)
    np.testing.assert_allclose(port.cost.numpy(), cost, rtol=1e-4)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_reference_matches_jax_batch_kernel(runs, case):
    state, its, gnorm, cost, nvalid, band_masked = runs[case]["batch"]
    assert np.all(band_masked == 0)  # the whole target sampled: no band
    port = _port_level(runs[case], case)
    _assert_level_match(port, state, its, cost, nvalid)
    np.testing.assert_allclose(port.gradient_norm.numpy(), gnorm, rtol=1e-3)
    if case[4] > 0:  # the threshold froze pairs at different iterations
        assert len(set(its.tolist())) > 1, its


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_reference_matches_exact_per_pair(runs, case):
    state, its, gnorm, cost, nvalid = runs[case]["exact"][:5]
    port = _port_level(runs[case], case)
    _assert_level_match(port, state, its, cost, nvalid)


@pytest.mark.parametrize("case", CASES[:4], ids=_case_id)
def test_reference_matches_torch_per_pair_oracle(runs, case):
    """The port's own exact per-pair oracle agrees with its batch path."""
    level, shape, sampling, its, mg = case
    I, D, _, _, init = runs[case]["frames"]
    port = _port_level(runs[case], case)
    It, Dt = torch.from_numpy(I), torch.from_numpy(D)
    gx, gy = tpyr.scharr(It, "x", SCALE), tpyr.scharr(It, "y", SCALE)
    for k in range(B):
        def linearize(s, k=k):
            r, J, v = tres.photometric_residual_jacobian(
                It[k], Dt[k], It[k + 1], gx[k + 1], gy[k + 1], s,
                runs[case]["intr"], 0.3, 5.0, sampling,
            )
            return tres.normal_equations(r, J, v)

        res = torch_gn_level(linearize, torch.from_numpy(init[k]), its, mg, 1.0)
        np.testing.assert_allclose(port.state[k].numpy(), res.state.numpy(), atol=2e-4)
        assert int(port.iterations[k]) == res.iterations
        assert float(port.num_valid[k]) == float(res.num_valid)


def test_cpu_wrapper_is_the_reference(runs):
    """On CPU tensors the wrapper returns the plain version's numbers and
    launches nothing."""
    case = CASES[0]
    before = FB.LAUNCHES
    a = _port_level(runs[case], case)
    b = _port_level(runs[case], case, FB.fused_gn_level_batch_reference)
    assert FB.LAUNCHES == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_zero_iterations_leave_state(runs):
    case = (2, (24, 32), "nearest", 0, 0.0)
    port = _port_level(runs[CASES[0]], case)
    np.testing.assert_array_equal(port.state.numpy(), runs[CASES[0]]["frames"][4])
    assert int(port.iterations.sum()) == 0
    assert float(port.gradient_norm.abs().sum()) == 0.0
