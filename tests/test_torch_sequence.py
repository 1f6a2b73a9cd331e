"""The analytic frame chain as a whole: phovo_tpu_torch's align_sequence /
align_sequence_chunk against phovo_tpu's on the CPU, on the same numpy
frames (the 96x128 `intr` fixture, 5 frames, 3 pyramid levels, the main
path's nearest sampling).

phovo_tpu runs its exact per-pair scan on the CPU; the port runs the
level-major batch path through the level kernel's plain version. The two
linearize with the same f32 math in two forms (u = tx fx / z vs
u = tx fx (1/z)) and sum in different orders. Tolerances: states 2e-4
absolute, cost 1e-4 relative, iterations and valid counts equal. Nearest
sampling turns ulp-level differences into occasional one-pixel sampling
flips that grow with every iteration on this non-converging plane (see
tests/test_torch_fused_batch.py), so the schedules keep a few iterations
per level.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from phovo_tpu.models.analytic import align_sequence as jax_align_sequence
from phovo_tpu.models.analytic import align_sequence_chunk as jax_align_sequence_chunk
from phovo_tpu.utils.config import PhovoConfig as JaxConfig
from phovo_tpu_torch.models.analytic import align_sequence, align_sequence_chunk
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.utils.config import PhovoConfig
from phovo_tpu_torch.utils.synthetic import make_sequence

torch.set_num_threads(1)

DEPTH_SCALE = 1.0 / 5000.0  # TUM 16-bit depth counts (datasets/tum.py)


def _config(max_iterations, min_gradient_norm):
    return JaxConfig(
        num_levels=3, blur_filter_sizes=(0, 0, 0), gradient_scales=(0.0625,) * 3,
        max_iterations=max_iterations, lambda_steps=(1.0,) * 3,
        min_gradient_norms=(min_gradient_norm,) * 3, sampling="nearest",
        mix_mode="f32",
    )


# fixed iterations (every level active), and early exit with level 0
# skipped like the main path's schedule, at a threshold that freezes
# pairs after different numbers of iterations
CONFIGS = {
    "fixed": _config((2, 2, 3), 0.0),
    "early_exit": _config((0, 3, 6), 15.0),
}


@pytest.fixture(scope="module")
def frames(intr):
    I, D, _, _ = make_sequence(
        Intrinsics(*(float(v) for v in intr)), (96, 128), 5, seed=2
    )
    I8 = np.round(np.stack(I) * 255.0).astype(np.uint8)
    D16 = np.round(np.stack(D) / DEPTH_SCALE).astype(np.uint16)
    return dict(I=np.stack(I), D=np.stack(D), I8=I8, D16=D16)


@pytest.fixture(scope="module")
def jax_runs(intr, frames):
    """phovo_tpu's results: align_sequence on float frames and
    align_sequence_chunk on storage-dtype frames, per config."""
    out = {}
    for name, cfg in CONFIGS.items():
        seq = jax_align_sequence(frames["I"], frames["D"], intr, cfg)
        chunk, ci, cd = jax_align_sequence_chunk(
            frames["I8"][0], frames["D"][0],
            frames["I8"][1:], frames["D16"][1:], intr, cfg,
            depth_scale=DEPTH_SCALE,
        )
        out[name] = dict(
            seq=jax.device_get(seq), chunk=jax.device_get(chunk),
            carry=(np.asarray(ci), np.asarray(cd)),
        )
    return out


def _assert_results_match(port, ref):
    np.testing.assert_allclose(port.state.numpy(), ref.state, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(port.iterations.numpy(), ref.iterations)
    np.testing.assert_array_equal(port.num_valid.numpy(), ref.num_valid)
    np.testing.assert_allclose(port.cost.numpy(), ref.cost, rtol=1e-4)
    assert float(port.band_masked.abs().sum()) == 0.0


def _port_config(name):
    return PhovoConfig.from_dict(dataclasses.asdict(CONFIGS[name]))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_align_sequence_matches_jax(intr, frames, jax_runs, name):
    port = align_sequence(
        torch.from_numpy(frames["I"]), torch.from_numpy(frames["D"]),
        Intrinsics(*(float(v) for v in intr)), _port_config(name),
    )
    ref = jax_runs[name]["seq"]
    _assert_results_match(port, ref)
    if CONFIGS[name].min_gradient_norms[0] > 0:
        assert len(set(ref.iterations[:, 2].tolist())) > 1, ref.iterations


@pytest.mark.parametrize("name", list(CONFIGS))
def test_align_sequence_chunk_matches_jax(intr, frames, jax_runs, name):
    """Storage dtypes (uint8 intensity, uint16 depth counts) converted on
    the device, the carry frame prepended there; carries equal bit for
    bit."""
    res, ci, cd = align_sequence_chunk(
        torch.from_numpy(frames["I8"][0]), torch.from_numpy(frames["D"][0]),
        torch.from_numpy(frames["I8"][1:]), torch.from_numpy(frames["D16"][1:]),
        Intrinsics(*(float(v) for v in intr)), _port_config(name),
        depth_scale=DEPTH_SCALE,
    )
    _assert_results_match(res, jax_runs[name]["chunk"])
    jci, jcd = jax_runs[name]["carry"]
    np.testing.assert_array_equal(ci.numpy(), jci)
    np.testing.assert_array_equal(cd.numpy(), jcd)

