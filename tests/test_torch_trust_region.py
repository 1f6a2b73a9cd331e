"""The trust-region level's plain version (fused_tr_level_batch_reference),
the port's trust-region solver and its config schedules, held to phovo_tpu
on the CPU.

References, all on the same numpy frames (a make_pair chain at 60x80, 3
pairs):
  * phovo_tpu's batched trust-region kernel fused_tr_level_batch in
    interpret mode, exact f32 sampling, two pairs a grid step (B2);
  * phovo_tpu's per-pair trust-region kernel fused_tr_level in interpret
    mode (B5), against the port's per-pair level (B = 1);
  * phovo_tpu's exact trust_region_level solver.
At H <= 60 the TPU kernels' banded row window covers every row the warps
reach (band_masked is asserted 0), so they sample what the port samples.

Tolerances: states 2e-4 absolute and cost 1e-4 relative (float32 pixel
sums in another order, amplified by the 6x6 solve; the level
tests/test_fused_batch.py pins for the TPU kernels), iterations equal,
valid counts within 0.5, radius 1e-4 relative. The radius is compared over
at most 4 iterations: once a pair has converged to float32 noise (5-6
iterations here), rho is a ratio of noise-level cost changes and the
radius rule halves or grows it by chance. Init states are small seeded
perturbations of zero: at exactly zero a border pixel warps onto the
bilinear in-bounds edge u = 0, where XLA's code and torch's round to
opposite sides (tests/test_torch_fused_batch.py). The early-exit cases
stop on the gradient, function or parameter tolerance, each set at least
7% from every value its test reads before it stops a pair
(test_early_exit_tolerances_are_off_their_boundaries), so the pairs stop
at different iterations whatever the summation order.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phovo_tpu.ops import fused as jfused
from phovo_tpu.ops.camera import Intrinsics as JIntrinsics
from phovo_tpu.ops.fused_batch import fused_tr_level_batch as jax_tr_batch
from phovo_tpu.ops.residuals import normal_equations as jax_ne
from phovo_tpu.ops.residuals import photometric_residual_jacobian as jax_prj
from phovo_tpu.solvers.trust_region import TROptions as JTROptions
from phovo_tpu.solvers.trust_region import residual_to_linearizer as jax_r2l
from phovo_tpu.solvers.trust_region import trust_region_level as jax_trl
from phovo_tpu.utils import config as jconfig
from phovo_tpu_torch.ops import fused_batch as FB
from phovo_tpu_torch.ops import pyramid as tpyr
from phovo_tpu_torch.ops import residuals as tres
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.fused import fused_tr_level, pack_geometry, pack_target
from phovo_tpu_torch.solvers import trust_region as ttr
from phovo_tpu_torch.utils import config as tconfig
from phovo_tpu_torch.utils.synthetic import make_pair

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SHAPE = (60, 80)
B = 3
SCALE = 0.0625
INTR = Intrinsics(80.0, 80.0, 39.5, 29.5)
JINTR = JIntrinsics(*(np.float32(v) for v in INTR))
TIGHT = dict(function_tolerance=1e-9, gradient_tolerance=1e-12, parameter_tolerance=1e-10)
# (level of the 60x80 frames, iterations, tolerances): fixed iterations at
# both levels, and early exit on the gradient tolerance (stops at
# iterations [2, 2, 3] at 30x40 and [3, 4, 4] at 60x80), the function
# tolerance ([6, 6, 7] at 60x80) and the parameter tolerance ([5, 6, 6] at
# 30x40)
CASES = [
    (1, 4, TIGHT),
    (0, 4, TIGHT),
    (1, 10, dict(TIGHT, gradient_tolerance=3.0)),
    (0, 10, dict(TIGHT, gradient_tolerance=5.2)),
    (0, 10, dict(TIGHT, function_tolerance=0.26)),
    (1, 10, dict(TIGHT, parameter_tolerance=0.0123)),
]
EARLY_EXIT = [case for case in CASES if case[2] != TIGHT]


def _stopping_test(tol):
    """The option of the one stopping test a case sets off TIGHT."""
    return next((k for k in TIGHT if tol[k] != TIGHT[k]), "gradient_tolerance")


def _case_id(case):
    level, its, tol = case
    H, W = tpyr.level_shape(SHAPE, level)
    name = _stopping_test(tol)
    return f"{H}x{W}-{its}it-{name[0]}{tol[name]:g}"


@functools.cache
def _chip_smoke():
    """chip_smoke.py as a module (it runs its phases only as a script)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.fixture(scope="module")
def frames():
    """A chain of B+1 frames (pair k aligns frame k to k+1), the per-level
    images, and seeded init states."""
    chain = []
    for k in range(B + 1):
        st = np.array([0.01, -0.005, 0.008, 0.004, -0.003, 0.002]) * (k + 1)
        I0, D0, I1, D1, _ = make_pair(INTR, shape=SHAPE, state=st)
        if k == 0:
            chain.append((I0, D0))
        chain.append((I1, D1))
    I = torch.from_numpy(np.stack([f[0] for f in chain[:B + 1]]))
    D = torch.from_numpy(np.stack([f[1] for f in chain[:B + 1]]))
    levels = {}
    for level in (0, 1):
        img = tpyr.build_pyramid(I, level + 1)[level]
        dep = tpyr.build_pyramid(D, level + 1)[level]
        levels[level] = dict(
            img=img, dep=dep,
            t_all=pack_target(img, tpyr.scharr(img, "x", SCALE), tpyr.scharr(img, "y", SCALE)),
        )
    init = (np.random.default_rng(0).standard_normal((B, 6)) * 1e-3).astype(np.float32)
    return dict(levels=levels, init=init)


def _port_args(frames, level):
    lv = frames["levels"][level]
    H, W = lv["img"].shape[-2:]
    intr = INTR.at_level(level)
    return (
        lv["img"][:-1].reshape(B, -1).contiguous(),
        pack_geometry(lv["dep"][:-1], intr, 0.3, 5.0).contiguous(),
        lv["t_all"][1:].contiguous(), intr, torch.from_numpy(frames["init"]),
    ), dict(H=H, W=W)


def _jax_level(frames, level, k):
    """pair k's (source image, source depth, target col-major pack) at one
    level, as phovo_tpu's kernels take them."""
    lv = frames["levels"][level]
    img, dep, t = (lv[n].numpy() for n in ("img", "dep", "t_all"))
    return (
        jnp.asarray(img[k]), jnp.asarray(dep[k]),
        jfused.pack_target_colmajor(*(jnp.asarray(t[k + 1, c]) for c in range(3))),
    )


@pytest.fixture(scope="module")
def jax_runs(frames):
    """Per case: phovo_tpu's batched kernel B2 over the 3 pairs and its
    per-pair kernel B5 on pair 0, both in interpret mode."""
    out = {}
    for case in CASES:
        level, its, tol = case
        opts = JTROptions(max_iterations=its, **tol)
        H, W = tpyr.level_shape(SHAPE, level)
        NP, _ = jfused._pick_tile_pixels(H, W)
        jintr = JINTR.at_level(level)
        per_pair = [_jax_level(frames, level, k) for k in range(B)]
        batch = jax_tr_batch(
            jnp.concatenate([jfused._pad_flat(si.reshape(1, H * W), NP) for si, _, _ in per_pair]),
            jnp.stack([jfused.pack_geometry(sd, jintr, 0.3, 5.0, NP) for _, sd, _ in per_pair]),
            jnp.stack([t for _, _, t in per_pair]),
            jintr, jnp.asarray(frames["init"]), 0.3, 5.0, opts,
            H=H, W=W, sampling="bilinear", interpret=True, mix_mode="f32", streams=2,
        )
        si, sd, t = per_pair[0]
        single = jfused.fused_tr_level(
            si, sd, t, jintr, jnp.asarray(frames["init"][0]), 0.3, 5.0, opts,
            sampling="bilinear", interpret=True, mix_mode="f32",
        )
        out[_case_id(case)] = dict(
            batch=[np.asarray(x) for x in batch], single=[np.asarray(x) for x in single],
        )
    return out


def _opts(case):
    return ttr.TROptions(max_iterations=case[1], **case[2])


def _assert_tr_match(port, ref, case):
    """port: TRLevelBatchResult-ordered tensors; ref: phovo_tpu's tuple in
    the same order (state, iterations, cost, gradient_norm, radius,
    num_valid, band_masked)."""
    state, its, cost, gnorm, radius, nvalid, masked = ref
    assert np.all(masked == 0)  # the whole target sampled: no band
    np.testing.assert_allclose(port[0].numpy(), state, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(port[1].numpy(), its)
    np.testing.assert_allclose(port[2].numpy(), cost, rtol=1e-4)
    np.testing.assert_allclose(port[5].numpy(), nvalid, rtol=0, atol=0.5)
    np.testing.assert_allclose(port[3].numpy(), gnorm, rtol=1e-3)
    if np.max(its) <= 4:
        np.testing.assert_allclose(port[4].numpy(), radius, rtol=1e-4)
    assert float(port[6].abs().sum()) == 0.0


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_reference_matches_jax_batch_kernel(frames, jax_runs, case):
    args, kw = _port_args(frames, case[0])
    port = FB.fused_tr_level_batch_reference(*args, _opts(case), **kw)
    ref = jax_runs[_case_id(case)]["batch"]
    _assert_tr_match(port, ref, case)
    if case in EARLY_EXIT:  # the tolerance froze pairs apart, within budget
        assert len(set(ref[1].tolist())) > 1 and ref[1].max() < case[1], ref[1]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_per_pair_level_matches_jax_per_pair_kernel(frames, jax_runs, case):
    """ops/fused.fused_tr_level (pack one pair, the batched level at B = 1)
    against phovo_tpu's per-pair kernel B5."""
    level = case[0]
    lv = frames["levels"][level]
    port = fused_tr_level(
        lv["img"][0], lv["dep"][0], lv["t_all"][1], INTR.at_level(level),
        torch.from_numpy(frames["init"][0]), 0.3, 5.0, _opts(case),
    )
    single = jax_runs[_case_id(case)]["single"]
    _assert_tr_match(
        [x[None] for x in port], [np.asarray(x)[None] for x in single], case,
    )


@pytest.mark.parametrize("case", EARLY_EXIT, ids=_case_id)
def test_early_exit_tolerances_are_off_their_boundaries(frames, case):
    """Every value an early-exit case's stopping test reads up to the
    iteration where it stops a pair lies at least chip_smoke's
    EARLY_EXIT_MARGIN from the tolerance, and the plain version stops
    where those values say (read with chip_smoke.stop_values)."""
    smoke = _chip_smoke()
    level, its, tol = case
    name = _stopping_test(tol)
    args, kw = _port_args(frames, level)
    values = smoke.stop_values(FB, args, ttr.TROptions(its, **TIGHT), **kw)[name]
    stops = smoke.predicted_stops(values, tol[name])
    for b, n in enumerate(stops.tolist()):
        ratio = values[: n + 1, b] / tol[name]
        ratio = ratio[torch.isfinite(ratio)]
        margin = smoke.EARLY_EXIT_MARGIN
        assert bool(((ratio >= margin) | (ratio <= 1 / margin)).all()), (b, ratio)
    port = FB.fused_tr_level_batch_reference(*args, _opts(case), **kw)
    assert port.iterations.tolist() == stops.tolist()


@pytest.mark.parametrize("name", list(TIGHT))
def test_chip_smoke_early_exit_tolerance(frames, name):
    """chip_smoke.early_exit_tolerance, which sets the card's early-exit
    cases: its tolerance stops every pair after at least one iteration,
    one at least before the budget, where the plain version stops."""
    smoke = _chip_smoke()
    args, kw = _port_args(frames, 0)
    opts = ttr.TROptions(10, **TIGHT)
    tol, stops = smoke.early_exit_tolerance(smoke.stop_values(FB, args, opts, **kw)[name])
    assert bool((stops > 0).all()) and int(stops.min()) < 10, stops
    port = FB.fused_tr_level_batch_reference(*args, opts._replace(**{name: tol}), **kw)
    assert port.iterations.tolist() == stops.tolist()


@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
def test_chip_smoke_warped_uv_is_the_plain_validity(frames, sampling):
    """chip_smoke.warped_uv, which names the pixels behind a count or cost
    difference on the card, flags the pixels the plain version counts."""
    smoke = _chip_smoke()
    args, kw = _port_args(frames, 0)
    gram = FB.fused_lin_batch_reference(*args, sampling=sampling, **kw)
    valid = smoke.warped_uv(FB, args[1], args[4], args[3], kw["H"], kw["W"], sampling)[2]
    assert torch.equal(valid.sum(dim=1).to(torch.float32), gram[:, 7, 7])


class _ShiftedKernel:
    """fused_batch with its GN 'kernel' replaced by the plain version from
    a shifted start: another trajectory, the same sums."""

    def __getattr__(self, name):
        return getattr(FB, name)

    def fused_gn_level_batch(self, i0, geom, t_all, intr, init, *args, **kw):
        return FB.fused_gn_level_batch_reference(i0, geom, t_all, intr, init + 1e-3, *args, **kw)


def test_chip_smoke_attribute_nearest_cost(frames, monkeypatch):
    """chip_smoke.attribute_nearest_cost passes a nearest cost difference
    that sample flips make while the sums agree at the same state, and
    refuses one whose cost is off at its own state."""
    smoke = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    args, kw = _port_args(frames, 0)
    gn_args = (*args[:4], torch.zeros((B, 6)), 3, 0.0, 1.0)
    kw = dict(kw, sampling="nearest", robust_loss="huber", robust_delta=0.02)
    fake = _ShiftedKernel()
    k = fake.fused_gn_level_batch(*gn_args, **kw)
    p = FB.fused_gn_level_batch_reference(*gn_args, **kw)
    assert float(((k.cost - p.cost).abs() / p.cost).max()) > smoke.COST_RTOL
    smoke.attribute_nearest_cost(fake, gn_args, kw, k, p, "shifted start", "CPU")
    with pytest.raises(RuntimeError, match="same-state cost"):
        smoke.attribute_nearest_cost(fake, gn_args, kw, k._replace(cost=k.cost * 1.001), p, "cost off", "CPU")


def test_chip_smoke_explain_valid_diff(frames, monkeypatch):
    """chip_smoke.explain_valid_diff accepts a valid-count difference only
    where pixels across the in-bounds edge, moved at most EDGE_SHIFT_PX,
    account for it exactly."""
    smoke = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    args, kw = _port_args(frames, 0)
    geom, intr, H, W = args[1], args[3], kw["H"], kw["W"]
    p = FB.fused_tr_level_batch_reference(*args, ttr.TROptions(2, **TIGHT), **kw)
    moved = p.state + torch.tensor([1e-2, 1e-2, 0, 0, 0, 0])
    nv = smoke.warped_uv(FB, geom, moved, intr, H, W, "bilinear")[2].sum(dim=1).to(torch.float32)
    assert not torch.equal(nv, p.num_valid)
    k = p._replace(state=moved, num_valid=nv)
    with pytest.raises(RuntimeError, match="away from the in-bounds edge"):
        smoke.explain_valid_diff(FB, geom, intr, H, W, k, p, "moved")
    monkeypatch.setattr(smoke, "EDGE_SHIFT_PX", 10.0)
    smoke.explain_valid_diff(FB, geom, intr, H, W, k, p, "moved")
    with pytest.raises(RuntimeError, match="account for"):
        smoke.explain_valid_diff(FB, geom, intr, H, W, k._replace(num_valid=nv + 1), p, "count off")


def test_cpu_wrapper_is_the_reference(frames):
    """On CPU tensors the wrapper returns the plain version's numbers and
    launches nothing."""
    args, kw = _port_args(frames, 1)
    before = FB.TR_LAUNCHES
    a = FB.fused_tr_level_batch(*args, _opts(CASES[0]), **kw)
    b = FB.fused_tr_level_batch_reference(*args, _opts(CASES[0]), **kw)
    assert FB.TR_LAUNCHES == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _torch_linearize(frames, level, k):
    lv = frames["levels"][level]
    img, dep, t = lv["img"], lv["dep"], lv["t_all"]

    def fields(s):
        return tres.photometric_residual_jacobian(
            img[k], dep[k], t[k + 1, 0], t[k + 1, 1], t[k + 1, 2], s,
            INTR.at_level(level), 0.3, 5.0, "bilinear",
        )

    return fields


def _jax_linearize(frames, level, k):
    lv = frames["levels"][level]
    img, dep, t = (jnp.asarray(lv[n].numpy()) for n in ("img", "dep", "t_all"))

    def fields(s):
        return jax_prj(
            img[k], dep[k], t[k + 1, 0], t[k + 1, 1], t[k + 1, 2], s,
            JINTR.at_level(level), 0.3, 5.0, "bilinear",
        )

    return fields


@pytest.mark.parametrize("form", ["normal_equations", "residual_to_linearizer"])
@pytest.mark.parametrize("case", CASES[:2] + CASES[3:], ids=_case_id)
def test_trust_region_level_matches_jax(frames, case, form):
    """The port's per-pair solver (solvers/trust_region.py) against
    phovo_tpu's on the same exact linearization of pair 1, fed as
    NormalEquations or as (r, J) through residual_to_linearizer."""
    level, its, tol = case
    k = 1
    tf, jf = _torch_linearize(frames, level, k), _jax_linearize(frames, level, k)
    if form == "normal_equations":
        tlin = lambda s: tres.normal_equations(*tf(s))  # noqa: E731
        jlin = lambda s: jax_ne(*jf(s))  # noqa: E731
    else:
        def rj(fields):
            def f(s):
                r, J, _ = fields(s)
                return r.reshape(-1), J.reshape(-1, 6)
            return f

        tlin = ttr.residual_to_linearizer(
            rj(tf), num_valid_fn=lambda s: tf(s)[2].sum(dtype=torch.float32)
        )
        jlin = jax_r2l(rj(jf), num_valid_fn=lambda s: jf(s)[2].sum(dtype=jnp.float32))
    init = frames["init"][k]
    port = ttr.trust_region_level(tlin, torch.from_numpy(init), ttr.TROptions(its, **tol))
    ref = jax_trl(jlin, jnp.asarray(init), JTROptions(its, **tol))
    assert isinstance(port.iterations, int)
    _assert_tr_match(
        [torch.as_tensor(x)[None] for x in port],
        [np.asarray(x)[None] for x in ref], case,
    )


def test_trust_region_level_skips_zero_iterations(frames):
    """max_iterations <= 0 returns the state with zero diagnostics and the
    initial radius, as phovo_tpu's solver does (a skipped level)."""
    calls = []
    init = torch.from_numpy(frames["init"][0])
    res = ttr.trust_region_level(calls.append, init, ttr.TROptions(0, initial_trust_region_radius=1e8))
    assert calls == [] and torch.equal(res.state, init) and res.iterations == 0
    assert float(res.cost) == float(res.gradient_norm) == float(res.num_valid) == 0.0
    assert float(res.radius) == 1e8


# ---------------------------------------------------------------------------
# config schedules
# ---------------------------------------------------------------------------

PRESETS = sorted((REPO / "phovo_tpu" / "configs").glob("*.yml"))


@pytest.mark.parametrize("path", PRESETS, ids=lambda p: p.stem)
def test_presets_parse_identically(path):
    """Every shipped preset loads to the same fields through both packages,
    and gives the same trust-region options at every level."""
    port, ref = tconfig.load_config(path), jconfig.load_config(path)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for level in range(ref.num_levels):
        assert tuple(port.trust_region_options(level)) == tuple(ref.trust_region_options(level))


def test_builtin_loader_finds_the_presets():
    name = "config_5_level_optimization_ceres"
    assert tconfig.load_builtin(name) == tconfig.load_config(
        REPO / "phovo_tpu" / "configs" / f"{name}.yml"
    )


REFERENCE_SCHEMA = """%YAML:1.0
---
numOptimizationLevels: 3
"blurFilterSize (at each level)": [3, 0, 0, 0]
"imageGradientsScalingFactor (at each level)": [0.0625, 0.0625]
"max_num_iterations (at each level)": [2, 5, 10]
"function_tolerance (at each level)": ['1e-4', '1e-4', '1e-5']
"initial_trust_region_radius (at each level)": ['1e8', '1e4', '1e4']
"min_relative_decrease (at each level)": ['1e-3', '1e-3', '1e-3']
minimizer_progress_to_stdout: 1
no_such_key: 7
"""


def test_reference_schema_and_overrides(tmp_path):
    """OpenCV FileStorage YAML (`%YAML:1.0` header, "(at each level)" keys,
    string floats, arrays longer or shorter than numOptimizationLevels,
    unknown keys) and CLI-style overrides, as phovo_tpu reads them."""
    path = tmp_path / "ref.yml"
    path.write_text(REFERENCE_SCHEMA)
    port, ref = tconfig.load_config(path), jconfig.load_config(path)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.blur_filter_sizes == (3, 0, 0) and port.gradient_scales == (0.0625,) * 3
    kw = dict(sampling="bilinear", min_depth=None, robust_loss="huber")
    assert dataclasses.asdict(tconfig.override_config(port, **kw)) == dataclasses.asdict(
        jconfig.override_config(ref, **kw)
    )
    assert tconfig.override_config(port) is port
    with pytest.raises(ValueError, match="num_levels"):
        tconfig.config_from_dict({"max_iterations": [1]})


def test_chip_smoke_preset_is_the_shipped_one():
    """chip_smoke.py runs on a machine without pyyaml, so it spells the
    preset out; it must stay the shipped file."""
    port = tconfig.config_from_dict(_chip_smoke().CERES_PRESET)
    ref = jconfig.load_builtin("config_5_level_optimization_ceres")
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
