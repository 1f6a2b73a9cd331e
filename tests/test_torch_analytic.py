"""The analytic backend per pair and its frame chains, with every loss and
Jacobian form: phovo_tpu_torch's align_analytic, align_sequence,
align_sequence_chunk and PhotoconsistencyOdometryAnalytic against
phovo_tpu's on the CPU, on the same numpy frames (a 4-frame make_sequence
chain at 96x128, 3 pyramid levels, a bright occluder in every target).

On the CPU phovo_tpu runs its exact XLA routes (the packed linearization
for 'warped', the reference one for 'esm' and 'source'), pair after pair,
and takes them whatever use_fused says; the port runs the level kernel's
plain version (per pair at B = 1, or level-major over the chain) and, for
'source' and use_fused=False, its exact torch path. tdist chains run
level-major in the port, per pair in phovo_tpu.

Tolerances: states 2e-4 absolute, cost 1e-4 relative, iterations and
valid counts equal (tests/test_torch_sequence.py's). The frames' depth is
zero on an 8-pixel border, at every level at least 2 pixels: from the
zero state a border pixel warps onto the bilinear in-bounds edge u = 0,
where phovo_tpu's exact form (u = tx fx / z) and the kernels' form
(u = tx fx (1/z)) round to opposite sides (tests/test_torch_fused_batch.py),
and that one pixel moves the costs by 1e-3. Bilinear schedules run
whole; nearest ones 3 iterations (see tests/test_torch_fused_batch.py);
the early-exit schedules' min_gradient_norm sits at least 7% from every
||J^T r|| the plain version reads before a stop
(test_early_exit_thresholds_are_off_their_boundaries).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from phovo_tpu.models.analytic import PhotoconsistencyOdometryAnalytic as JaxAnalytic
from phovo_tpu.models.analytic import align_sequence as jax_align_sequence
from phovo_tpu.models.analytic import align_sequence_chunk as jax_align_sequence_chunk
from phovo_tpu.ops.camera import Intrinsics as JIntrinsics
from phovo_tpu.utils.config import PhovoConfig as JaxConfig
import phovo_tpu_torch
from phovo_tpu_torch.models import BACKENDS
from phovo_tpu_torch.models import analytic as tan
from phovo_tpu_torch.ops import fused_batch as FB
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.robust import TDIST_BURNIN
from phovo_tpu_torch.utils.config import PhovoConfig, builtin_config_dir, load_builtin
from phovo_tpu_torch.utils.synthetic import make_sequence

torch.set_num_threads(1)

SHAPE = (96, 128)
N_FRAMES = 4
INTR = Intrinsics(128.0, 128.0, 63.5, 47.5)
JINTR = JIntrinsics(*(np.float32(v) for v in INTR))
DEPTH_SCALE = 1.0 / 5000.0
EARLY_EXIT_MARGIN = 1.07

BASE = JaxConfig(
    num_levels=3, blur_filter_sizes=(0,) * 3, gradient_scales=(0.0625,) * 3,
    max_iterations=(3, 3, 4), lambda_steps=(1.0,) * 3, min_gradient_norms=(0.0,) * 3,
    sampling="bilinear", mix_mode="f32",
)
NEAREST = dict(sampling="nearest", max_iterations=(1, 1, 1))
# the coarsest level alone, from zero, 8 iterations at most
EARLY = dict(max_iterations=(0, 0, 8))
# tests/test_robust.py:117-118's scales
VARIANTS = {
    "none": {},
    "huber": dict(robust_loss="huber", robust_delta=0.02),
    "cauchy": dict(robust_loss="cauchy", robust_delta=0.02),
    "tukey": dict(robust_loss="tukey", robust_delta=0.1),
    "tdist": dict(robust_loss="tdist", robust_delta=0.1),
    "esm": dict(gradient_at="esm"),
    "source": dict(gradient_at="source"),
    "tdist-esm": dict(robust_loss="tdist", robust_delta=0.1, gradient_at="esm"),
    "huber-nearest": dict(robust_loss="huber", robust_delta=0.02, **NEAREST),
    "tdist-nearest": dict(robust_loss="tdist", robust_delta=0.1, **NEAREST),
    "source-nearest": dict(gradient_at="source", **NEAREST),
    # the pairs stop after [8 (the budget), 3, 3], [5, 6, 6] and [4, 6, 6]
    # iterations
    "early-none": dict(EARLY, min_gradient_norms=(3.0,) * 3),
    "early-cauchy": dict(EARLY, robust_loss="cauchy", robust_delta=0.02, min_gradient_norms=(1.0,) * 3),
    "early-tdist": dict(EARLY, robust_loss="tdist", robust_delta=0.1, min_gradient_norms=(1.6,) * 3),
}
EARLY_NAMES = [name for name in VARIANTS if name.startswith("early")]


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


def _jax(x):
    return jax.tree.map(np.asarray, jax.device_get(x))


@pytest.fixture(scope="module")
def jax_scans(frames):
    """phovo_tpu's align_sequence (a scan of align_analytic from zero) per
    variant, on uint8 frames."""
    return {
        name: _jax(jax_align_sequence(frames["I8"], frames["D"], JINTR, _jcfg(name)))
        for name in VARIANTS
    }


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_match(port, ref):
    np.testing.assert_allclose(port.state.numpy(), ref.state, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(port.iterations.numpy(), ref.iterations)
    np.testing.assert_array_equal(port.num_valid.numpy(), ref.num_valid)
    np.testing.assert_allclose(port.cost.numpy(), ref.cost, rtol=1e-4)
    assert float(port.band_masked.abs().sum()) == 0.0


@pytest.mark.parametrize("name", list(VARIANTS))
def test_align_analytic_matches_jax(frames, jax_scans, name):
    """Per pair: one level-kernel call per active level (the exact torch
    path for 'source')."""
    port = [
        tan.align_analytic(
            _t(frames["I8"][k]), _t(frames["D"][k]), _t(frames["I8"][k + 1]),
            _t(frames["D"][k + 1]), INTR, torch.zeros(6), _tcfg(name),
        )
        for k in range(N_FRAMES - 1)
    ]
    _assert_match(tan.AlignmentResult(*(torch.stack(x) for x in zip(*port))), jax_scans[name])


@pytest.mark.parametrize("name", list(VARIANTS))
def test_align_sequence_matches_jax(frames, jax_scans, name):
    """The zero-init chain: level-major through the level kernel (tdist
    too), the exact path pair after pair for 'source'."""
    port = tan.align_sequence(_t(frames["I8"]), _t(frames["D"]), INTR, _tcfg(name))
    _assert_match(port, jax_scans[name])


@pytest.mark.parametrize("name", ["none", "tdist", "esm", "source"])
def test_use_fused_false_matches_jax(frames, name):
    """use_fused=False: the exact torch path (gauss_newton_level over
    photometric_residual_jacobian + normal_equations) against phovo_tpu's
    use_fused=False."""
    ref = _jax(jax_align_sequence(frames["I"], frames["D"], JINTR, _jcfg(name), use_fused=False))
    before = FB.LAUNCHES
    port = tan.align_sequence(_t(frames["I"]), _t(frames["D"]), INTR, _tcfg(name), use_fused=False)
    _assert_match(port, ref)
    vo = tan.PhotoconsistencyOdometryAnalytic(_tcfg(name), device="cpu")
    full = vo.align_full_band(_t(frames["I"][0]), _t(frames["D"][0]), _t(frames["I"][1]),
                              _t(frames["D"][1]), INTR, torch.zeros(6))
    np.testing.assert_array_equal(full.state.numpy(), port.state[0].numpy())
    assert FB.LAUNCHES == before


@pytest.mark.parametrize("name", ["none", "huber", "tdist", "esm", "source", "early-none"])
def test_warm_started_sequence_matches_jax(frames, name):
    """warm_start: each pair starts where the one before ended (the port's
    serial chain over per-frame packs computed once)."""
    ref = _jax(jax_align_sequence(frames["I"], frames["D"], JINTR, _jcfg(name), warm_start=True))
    port = tan.align_sequence(_t(frames["I"]), _t(frames["D"]), INTR, _tcfg(name), warm_start=True)
    _assert_match(port, ref)
    zero = tan.align_sequence(_t(frames["I"]), _t(frames["D"]), INTR, _tcfg(name))
    assert not torch.equal(port.state[1:], zero.state[1:])


@pytest.mark.parametrize("name,warm_start", [("tdist", True), ("esm", False), ("huber", True)])
def test_align_sequence_chunk_matches_jax(frames, name, warm_start):
    """Storage dtypes converted on the device, the carry frame prepended
    there; warm_start chains the chunk's pairs from zero, as phovo_tpu's
    does."""
    args = (frames["I8"][0], frames["D"][0], frames["I8"][1:], frames["D16"][1:])
    ref, jci, jcd = jax_align_sequence_chunk(
        *args, JINTR, _jcfg(name), warm_start=warm_start, depth_scale=DEPTH_SCALE,
    )
    port, ci, cd = tan.align_sequence_chunk(
        *map(_t, args), INTR, _tcfg(name), warm_start=warm_start, depth_scale=DEPTH_SCALE,
    )
    _assert_match(port, _jax(ref))
    np.testing.assert_array_equal(ci.numpy(), np.asarray(jci))
    np.testing.assert_array_equal(cd.numpy(), np.asarray(jcd))


@pytest.mark.parametrize("name", EARLY_NAMES)
def test_early_exit_thresholds_are_off_their_boundaries(frames, name):
    """Every ||J^T r|| the plain level reads up to the iteration where an
    early-exit schedule stops a pair lies at least 7% from its
    min_gradient_norm, so another summation order cannot flip a stop; the
    pairs stop after different counts, one at least before the budget."""
    cfg = _tcfg(name)
    level, n = 2, cfg.max_iterations[2]
    I8, D = _t(frames["I8"]), _t(frames["D"])
    stops = tan.align_sequence(I8, D, INTR, cfg).iterations[:, level]
    i0, geom, t_all = tan.prep_frame_analytic(I8.to(torch.float32) * (1.0 / 255.0), D, INTR, cfg)[level]
    H, W = tan.pyr.level_shape(SHAPE, level)
    gnorm = torch.stack([
        FB.fused_gn_level_batch(
            i0[:-1], geom[:-1], t_all[1:], INTR.at_level(level), torch.zeros((N_FRAMES - 1, 6)),
            it, 0.0, 1.0, H=H, W=W, sampling=cfg.sampling, robust_loss=cfg.robust_loss,
            robust_delta=cfg.robust_delta,
            tdist_burnin=TDIST_BURNIN if cfg.robust_loss == "tdist" else 0,
        ).gradient_norm
        for it in range(1, n + 1)
    ])
    assert len(set(stops.tolist())) > 1 and int(stops.min()) < n, stops
    for k, stop in enumerate(stops.tolist()):
        ratio = gnorm[:stop, k] / cfg.min_gradient_norms[level]
        assert bool(((ratio >= EARLY_EXIT_MARGIN) | (ratio <= 1 / EARLY_EXIT_MARGIN)).all()), (k, ratio)


def test_object_api_matches_jax(frames):
    """The reference's object interface: intrinsics, frames (uint8 and
    metric depth), an initial state, optimize, the optimal state and its
    rigid transformation, and the exact-path re-run."""
    K = [[INTR.fx, 0.0, INTR.cx], [0.0, INTR.fy, INTR.cy], [0.0, 0.0, 1.0]]
    init = np.array([0.002, -0.001, 0.003, 0.001, 0.0, -0.002], np.float32)
    out = []
    for make in (lambda: JaxAnalytic(_jcfg("huber")),
                 lambda: tan.PhotoconsistencyOdometryAnalytic(_tcfg("huber"), device="cpu")):
        vo = make()
        vo.set_intrinsic_matrix(np.asarray(K))
        vo.set_source_frame(frames["I8"][0], frames["D"][0])
        vo.set_target_frame(frames["I8"][1], frames["D"][1])
        vo.set_initial_state_vector(init)
        res = vo.optimize()
        out.append((np.asarray(vo.get_optimal_state_vector()),
                    np.asarray(vo.get_optimal_rigid_transformation_matrix()), res))
    (js, jT, jres), (ts, tT, tres) = out
    np.testing.assert_allclose(ts, js, rtol=0, atol=2e-4)
    np.testing.assert_allclose(tT, jT, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(tres.iterations.numpy(), np.asarray(jres.iterations))
    assert tT.shape == (4, 4)


def test_object_api_refuses_before_setup_and_reads_presets(tmp_path):
    vo = BACKENDS["analytic"](device="cpu")
    with pytest.raises(RuntimeError, match="set_intrinsic_matrix"):
        vo.optimize()
    with pytest.raises(RuntimeError, match="optimize"):
        vo.get_optimal_state_vector()
    preset = load_builtin("config_5_level_optimization_analytic")
    vo.read_configuration_file(
        builtin_config_dir() / "config_5_level_optimization_analytic.yml"
    )
    assert vo.config == preset
    assert preset.max_iterations == (0, 0, 5, 20, 50) and preset.sampling == "nearest"
    vo.set_min_depth(0.5)
    vo.set_max_depth(4.0)
    assert (vo.config.min_depth, vo.config.max_depth) == (0.5, 4.0)


def test_exports():
    assert BACKENDS["analytic"] is tan.PhotoconsistencyOdometryAnalytic
    assert phovo_tpu_torch.align_analytic is tan.align_analytic
    assert phovo_tpu_torch.PhotoconsistencyOdometryAnalytic is tan.PhotoconsistencyOdometryAnalytic


def test_cpu_routes_launch_nothing(frames):
    """Every analytic entry point on CPU tensors runs the plain versions."""
    before = (FB.LAUNCHES, FB.TR_LAUNCHES, FB.LIN_LAUNCHES)
    for name in ("tdist", "esm"):
        tan.align_sequence(_t(frames["I"]), _t(frames["D"]), INTR, _tcfg(name), warm_start=True)
        tan.align_analytic(_t(frames["I"][0]), _t(frames["D"][0]), _t(frames["I"][1]),
                           _t(frames["D"][1]), INTR, torch.zeros(6), _tcfg(name))
    assert (FB.LAUNCHES, FB.TR_LAUNCHES, FB.LIN_LAUNCHES) == before


@pytest.mark.parametrize(
    "attr,preset",
    [("ANALYTIC_PRESET", "config_5_level_optimization_analytic"),
     ("LEVEL0_PRESET", "config_only_level_0_analytic")],
)
def test_chip_smoke_presets_are_the_shipped_ones(attr, preset):
    """chip_smoke.py runs on a machine without pyyaml, so it spells the
    analytic presets out; they must stay the shipped files."""
    import importlib.util
    from pathlib import Path

    from phovo_tpu.utils import config as jconfig
    from phovo_tpu_torch.utils.config import config_from_dict

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    port = config_from_dict(getattr(smoke, attr))
    assert dataclasses.asdict(port) == dataclasses.asdict(jconfig.load_builtin(preset))
    assert port == load_builtin(preset)
