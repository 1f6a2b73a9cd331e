"""phovo_tpu_torch never imports jax, never falls back silently, and
refuses what it has not ported.

The kernels (the Gauss-Newton levels, photometric and bi-objective, the
trust-region level, the one linearization, the inverse-compositional
precompute and level) run only on CUDA tensors; on CPU tensors the wrappers take the plain versions and
launch nothing; any other device, a missing nvcc, or a card that is not
there raises instead of computing elsewhere. The object API runs on the
card unless the caller names another device.
"""

import dataclasses
import inspect
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import phovo_tpu_torch
from phovo_tpu_torch.models import BACKENDS
from phovo_tpu_torch.models import autodiff as tad
from phovo_tpu_torch.models.analytic import align_sequence, align_sequence_chunk
from phovo_tpu_torch.ops import _build
from phovo_tpu_torch.ops import fused_batch as FB
from phovo_tpu_torch.ops import ic as IC
from phovo_tpu_torch.ops import ic_batch as ICB
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.solvers.trust_region import TROptions
from phovo_tpu_torch.utils.config import PhovoConfig

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
INTR = Intrinsics(32.0, 32.0, 15.5, 11.5)
H, W = 24, 32


def _frames(n=3):
    rng = np.random.default_rng(0)
    I = torch.from_numpy(rng.random((n, H, W), dtype=np.float32))
    D = torch.from_numpy(rng.uniform(1.0, 3.0, (n, H, W)).astype(np.float32))
    return I, D


def _level_inputs(B=2, channels=3, rows=4, device="cpu"):
    rng = np.random.default_rng(1)

    def t(*shape):
        return torch.from_numpy(rng.random(shape, dtype=np.float32)).to(device)

    return (t(B, H * W), t(B, rows, H * W), t(B, channels, H, W), INTR,
            torch.zeros((B, 6), device=device))


CONFIG = PhovoConfig(
    num_levels=2, blur_filter_sizes=(0, 0), gradient_scales=(0.0625,) * 2,
    max_iterations=(2, 2), lambda_steps=(1.0,) * 2, min_gradient_norms=(0.0,) * 2,
)


def test_imports_without_jax():
    """Every module of the package imports with jax blocked, and neither
    jax nor phovo_tpu ends up loaded."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "phovo_tpu_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'phovo_tpu')]\n"
        "assert sys.modules['jax'] is None and loaded == ['jax'], loaded\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_matmul_and_conv_precision_is_full_float32():
    assert phovo_tpu_torch is not None
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cpu_tensors_launch_nothing():
    before = FB.LAUNCHES
    I, D = _frames()
    res = align_sequence(I, D, INTR, CONFIG)
    res_c, ci, cd = align_sequence_chunk(I[0], D[0], I[1:], D[1:], INTR, CONFIG)
    assert FB.LAUNCHES == before
    assert res.state.device.type == "cpu" and ci.device.type == "cpu"
    for a, b in zip(res, res_c):
        assert torch.equal(a, b)


def test_other_devices_raise():
    """A tensor on neither the CPU nor a CUDA card is refused, never
    computed somewhere else."""
    before = FB.LAUNCHES
    args = _level_inputs(device="meta")
    with pytest.raises(ValueError, match="no level kernel for device"):
        FB.fused_gn_level_batch(*args, 1, 0.0, 1.0, H=H, W=W)
    assert FB.LAUNCHES == before


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    """No nvcc: the build raises, and so does loading the library, which
    every wrapper does on a CUDA tensor before its launch."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    _build.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.library()
    finally:
        _build.library.cache_clear()


def _ic_inputs(B=2, device="cpu"):
    rng = np.random.default_rng(2)

    def t(*shape):
        return torch.from_numpy(rng.random(shape, dtype=np.float32)).to(device)

    frames = [t(B, H, W) for _ in range(4)]  # intensity, depth, grad_x, grad_y
    level = (torch.eye(4).repeat(B, 1, 1).to(device), t(B, 4, H * W), t(B, 8, H * W), t(B, 36), t(B, H, W))
    return frames, level


def test_ic_kernels_other_devices_raise():
    """The inverse-compositional wrappers refuse a tensor on neither the
    CPU nor a CUDA card, launching nothing; on CPU tensors they return
    their plain versions' results."""
    before = (IC.IC_PRE_LAUNCHES, ICB.IC_LAUNCHES)
    frames, level = _ic_inputs(device="meta")
    with pytest.raises(ValueError, match="no IC precompute kernel for device"):
        IC.ic_precompute_batch(*frames, INTR, 0.3, 5.0)
    with pytest.raises(ValueError, match="no IC level kernel for device"):
        ICB.ic_gn_level_batch(*level, INTR, 2, 0.0, 1.0, H=H, W=W)
    frames, level = _ic_inputs()
    J8, L = IC.ic_precompute_batch(*frames, INTR, 0.3, 5.0)
    assert all(torch.equal(a, b) for a, b in zip(
        (J8, L), IC.ic_precompute_batch_reference(*frames, INTR, 0.3, 5.0)))
    res = ICB.ic_gn_level_batch(*level, INTR, 2, 0.0, 1.0, H=H, W=W, sampling="bilinear")
    ref = ICB.ic_gn_level_batch_reference(*level, INTR, 2, 0.0, 1.0, H=H, W=W, sampling="bilinear")
    assert all(torch.equal(a, b) for a, b in zip(res, ref))
    assert (IC.IC_PRE_LAUNCHES, ICB.IC_LAUNCHES) == before


@pytest.mark.parametrize("fault", ["dtype", "contiguity", "shape", "sampling"])
def test_ic_kernel_input_checks(fault):
    _, (Ts, geom, J8, L, t_i) = _ic_inputs()
    kw = dict(H=H, W=W)
    if fault == "dtype":
        J8 = J8.double()
    elif fault == "contiguity":
        t_i = t_i.transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "shape":
        kw["W"] = W - 1
    else:
        kw["sampling"] = "bicubic"
    with pytest.raises(ValueError):
        ICB.ic_gn_level_batch(Ts, geom, J8, L, t_i, INTR, 1, 0.0, 1.0, **kw)


def test_object_api_defaults_to_the_card():
    """Every object-API backend defaults to the CUDA card; where torch finds
    none, the default raises (naming device="cpu") instead of running on
    the CPU, and device="cpu" runs there."""
    for name, cls in BACKENDS.items():
        default = inspect.signature(cls.__init__).parameters["device"].default
        assert torch.device(default) == torch.device("cuda"), name
        assert cls(device="cpu").device == torch.device("cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match='device="cpu"'):
                cls()


def test_pose_graph_defaults_to_the_card():
    """optimize_pose_graph on a graph of numpy arrays solves on the CUDA
    card unless the caller names a device; where torch finds none it raises
    (naming device="cpu") instead of solving on the CPU."""
    from phovo_tpu_torch.parallel import pose_graph as tpg

    graph = tpg.PoseGraph(
        states=np.zeros((3, 6), np.float32),
        edges_i=np.array([0, 1], np.int64),
        edges_j=np.array([1, 2], np.int64),
        measurements=np.full((2, 6), 0.01, np.float32),
        weights=np.ones(2, np.float32),
    )
    default = inspect.signature(tpg.optimize_pose_graph).parameters["device"].default
    assert default is None
    states, _ = tpg.optimize_pose_graph(graph, iterations=2, device="cpu")
    assert states.device == torch.device("cpu") and bool(torch.isfinite(states).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tpg.optimize_pose_graph(graph, iterations=2)
    else:
        assert tpg.optimize_pose_graph(graph, iterations=2)[0].device.type == "cuda"


def _run_smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, timeout=120,
    )


def test_chip_smoke_without_a_card_fails(tmp_path):
    """chip_smoke.py exits non-zero and prints no result when CUDA is not
    available, from the repository and from a directory holding only the
    script."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    for cwd in (REPO, tmp_path):
        if cwd is tmp_path:
            shutil.copy(REPO / "chip_smoke.py", tmp_path)
        proc = _run_smoke(cwd)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize(
    "layout,kw,what",
    [
        (dict(channels=6), {}, "needs depth_gains"),
        (dict(channels=6, rows=6), dict(esm=True, depth_gains=True), "photometric-only"),
        (dict(channels=6), dict(robust_loss="tdist", depth_gains=True), "photometric-only"),
        (dict(), dict(depth_gains=True), "bi-objective=True"),
        (dict(rows=6), {}, "esm=False"),
        (dict(), {}, "shared"),
    ],
    ids=["biobjective", "biobjective-esm", "biobjective-tdist", "biobjective-3-channels", "esm",
         "shared-source"],
)
def test_unported_kernel_layouts_raise(layout, kw, what):
    """The GN kernel refuses what it has no variant for: a six-channel
    (bi-objective) target without depth_gains, and depth_gains with ESM,
    with the Student-t loss (phovo_tpu raises the same) or with a
    three-channel target. ESM geometry is ported: six rows are read with
    esm=True and are a shape error without it. A shared source (one (1,
    N) source pack for every pair, keyframe tracking) is ported: it gives
    the bits of the same pack repeated, and with depth_gains it raises,
    as phovo_tpu has no bi-objective caller for it."""
    i0, geom, t_all, intr, states = _level_inputs(**layout)
    if kw.get("depth_gains"):
        kw = dict(kw, depth_gains=torch.full((2,), 0.25))
    if what == "shared":
        shared = (i0[:1].contiguous(), geom[:1].contiguous())
        replicated = (i0[:1].repeat(2, 1), geom[:1].repeat(2, 1, 1))
        for fn in (FB.fused_gn_level_batch, FB.fused_gn_level_batch_reference):
            res = [fn(*src, t_all, intr, states, 3, 0.0, 1.0, H=H, W=W, sampling="bilinear", robust_loss="huber")
                   for src in (shared, replicated)]
            assert all(torch.equal(a, b) for a, b in zip(*res))
        with pytest.raises(ValueError, match="shared source"):
            FB.fused_gn_level_batch(*shared, torch.cat([t_all, t_all], dim=1), intr, states, 1, 0.0, 1.0,
                                    H=H, W=W, depth_gains=torch.full((2,), 0.25))
        return
    for fn in (FB.fused_gn_level_batch, FB.fused_gn_level_batch_reference):
        with pytest.raises(ValueError, match=what):
            fn(i0, geom, t_all, intr, states, 1, 0.0, 1.0, H=H, W=W, **kw)
    if what == "esm=False":
        res = FB.fused_gn_level_batch(i0, geom, t_all, intr, states, 1, 0.0, 1.0, H=H, W=W, esm=True)
        assert bool(torch.isfinite(res.state).all())


def test_bi_level_cpu_and_other_devices():
    """The bi-objective level (K-GN-bi): the plain version on CPU tensors,
    launching nothing, and another device raises."""
    before = FB.LAUNCHES
    args = _level_inputs(channels=6)
    gains = torch.tensor([0.2, 0.3])
    kw = dict(H=H, W=W, sampling="bilinear", robust_loss="huber", depth_gains=gains)
    res = FB.fused_gn_level_batch(*args, 2, 0.0, 1.0, **kw)
    ref = FB.fused_gn_level_batch_reference(*args, 2, 0.0, 1.0, **kw)
    assert all(torch.equal(a, b) for a, b in zip(res, ref))
    with pytest.raises(ValueError, match="no level kernel for device"):
        FB.fused_gn_level_batch(*_level_inputs(channels=6, device="meta"), 1, 0.0, 1.0, H=H, W=W,
                                depth_gains=gains.to("meta"))
    assert FB.LAUNCHES == before


@pytest.mark.parametrize("fault", ["dtype", "contiguity", "shape", "sampling"])
def test_kernel_input_checks(fault):
    i0, geom, t_all, intr, states = _level_inputs()
    kw = dict(H=H, W=W)
    if fault == "dtype":
        i0 = i0.double()
    elif fault == "contiguity":
        t_all = t_all.transpose(2, 3).contiguous().transpose(2, 3)
    elif fault == "shape":
        kw["W"] = W - 1
    else:
        kw["sampling"] = "bicubic"
    with pytest.raises(ValueError):
        FB.fused_gn_level_batch(i0, geom, t_all, intr, states, 1, 0.0, 1.0, **kw)


def test_config_from_dict_rejects_unknown_fields():
    with pytest.raises(ValueError, match="unknown PhovoConfig fields"):
        PhovoConfig.from_dict({"num_levels": 1, "no_such_field": 1})


TR_CONFIG = dataclasses.replace(CONFIG, sampling="bilinear")


def test_cpu_trust_region_calls_launch_nothing():
    """Every trust-region entry point on CPU tensors runs the plain version:
    per pair, level-major, warm-started and chunked."""
    before = (FB.LAUNCHES, FB.TR_LAUNCHES)
    I, D = _frames()
    lm = tad.align_sequence_autodiff(I, D, INTR, TR_CONFIG)
    warm = tad.align_sequence_autodiff(I, D, INTR, TR_CONFIG, warm_start=True)
    chunk, ci, _ = tad.align_sequence_chunk_autodiff(I[0], D[0], I[1:], D[1:], INTR, TR_CONFIG)
    one = tad.align_autodiff(I[0], D[0], I[1], D[1], INTR, torch.zeros(6), TR_CONFIG)
    assert (FB.LAUNCHES, FB.TR_LAUNCHES) == before
    for res in (lm, warm, chunk, one):
        assert res.state.device.type == "cpu" and bool(torch.isfinite(res.state).all())
    assert ci.device.type == "cpu"


def test_lin_kernel_cpu_and_other_devices():
    """The one-linearization wrapper: the plain Gram on CPU tensors,
    launching nothing; another device raises."""
    before = FB.LIN_LAUNCHES
    i0, geom, t_all, intr, states = _level_inputs()
    gram = FB.fused_lin_batch(i0, geom, t_all, intr, states, H=H, W=W, robust_loss="tukey")
    assert torch.equal(gram, FB.fused_lin_batch_reference(
        i0, geom, t_all, intr, states, H=H, W=W, robust_loss="tukey"))
    assert gram.shape == (2, 8, 8) and float(gram[:, 6, 7].abs().sum()) == 0.0
    with pytest.raises(ValueError, match="no level kernel for device"):
        FB.fused_lin_batch(*_level_inputs(device="meta"), H=H, W=W)
    assert FB.LIN_LAUNCHES == before


def test_trust_region_other_devices_raise():
    before = FB.TR_LAUNCHES
    i0, geom, t_all, intr, states = _level_inputs(device="meta")
    with pytest.raises(ValueError, match="no level kernel for device"):
        FB.fused_tr_level_batch(i0, geom, t_all, intr, states, TROptions(2), H=H, W=W)
    assert FB.TR_LAUNCHES == before


@pytest.mark.parametrize(
    "kwargs,error",
    [
        (dict(jacobian_mode="numeric"), ValueError),
        (dict(robust_loss="tdist"), ValueError),
    ],
    ids=lambda v: "-".join(f"{k}={x}" for k, x in v.items()) if isinstance(v, dict) else "",
)
def test_unported_trust_region_routes_raise(kwargs, error):
    """An unknown Jacobian mode, and the Student-t loss, which has no
    trust-region solver (phovo_tpu raises the same ValueError): every entry
    point refuses them, and the kernel wrappers refuse tdist. (The jacfwd
    mode runs: tests/test_torch_jacfwd.py holds each entry point to
    phovo_tpu's.)"""
    mode = kwargs.pop("jacobian_mode", "linearizer")
    cfg = dataclasses.replace(TR_CONFIG, **kwargs)
    I, D = _frames()
    match = {"numeric": "jacobian_mode"}.get(mode, "tdist")
    calls = [
        lambda: tad.align_autodiff(I[0], D[0], I[1], D[1], INTR, torch.zeros(6), cfg, mode),
        lambda: tad.align_sequence_autodiff(I, D, INTR, cfg, mode),
        lambda: tad.align_sequence_autodiff(I, D, INTR, cfg, mode, warm_start=True),
        lambda: tad.align_sequence_chunk_autodiff(I[0], D[0], I[1:], D[1:], INTR, cfg, mode),
        lambda: tad.PhotoconsistencyOdometryAutodiff(cfg, mode, device="cpu").align(
            I[0], D[0], I[1], D[1], INTR, torch.zeros(6)),
    ]
    for call in calls:
        with pytest.raises(error, match=match):
            call()
    if mode == "linearizer":
        args = _level_inputs()
        for fn in (FB.fused_tr_level_batch, FB.fused_tr_level_batch_reference):
            with pytest.raises(ValueError, match="tdist"):
                fn(*args, TROptions(2), H=H, W=W, robust_loss="tdist")


@pytest.mark.parametrize("loss", ["huber", "cauchy", "tukey"])
def test_trust_region_robust_losses_run_on_the_plain_version(loss):
    """huber, cauchy and tukey run on every trust-region entry point (an
    'esm' config too: the ceres backend reads the warped-point gradient
    whatever gradient_at says); on CPU tensors through the plain version,
    launching nothing."""
    before = (FB.LAUNCHES, FB.TR_LAUNCHES, FB.LIN_LAUNCHES)
    cfg = dataclasses.replace(TR_CONFIG, robust_loss=loss, robust_delta=0.05, gradient_at="esm")
    I, D = _frames()
    results = [
        tad.align_sequence_autodiff(I, D, INTR, cfg),
        tad.align_sequence_autodiff(I, D, INTR, cfg, warm_start=True),
        tad.align_sequence_chunk_autodiff(I[0], D[0], I[1:], D[1:], INTR, cfg)[0],
        tad.align_autodiff(I[0], D[0], I[1], D[1], INTR, torch.zeros(6), cfg),
    ]
    for res in results:
        assert bool(torch.isfinite(res.state).all())
    plain = tad.align_sequence_autodiff(I, D, INTR, TR_CONFIG)
    assert not torch.equal(results[0].cost, plain.cost)  # the weights reached the level
    assert (FB.LAUNCHES, FB.TR_LAUNCHES, FB.LIN_LAUNCHES) == before


@pytest.mark.parametrize(
    "layout,what,error",
    [
        (dict(channels=6), "photometric", ValueError),
        (dict(rows=6), "ESM", ValueError),
        (dict(), "shared", None),
    ],
    ids=["biobjective", "esm", "shared-source"],
)
def test_unported_trust_region_layouts_raise(layout, what, error):
    """The trust-region kernel refuses the bi-objective six-channel target
    (its level is photometric, as phovo_tpu's) and ESM geometry (phovo_tpu's
    has no ESM; the ceres backend packs four rows whatever gradient_at
    says), each with a ValueError. The shared-source layout (keyframe
    tracking) is ported: one (1, N) source pack gives the bits of the same
    pack repeated for every pair."""
    i0, geom, t_all, intr, states = _level_inputs(**layout)
    if what == "shared":
        shared = (i0[:1].contiguous(), geom[:1].contiguous())
        replicated = (i0[:1].repeat(2, 1), geom[:1].repeat(2, 1, 1))
        for fn in (FB.fused_tr_level_batch, FB.fused_tr_level_batch_reference):
            res = [fn(*src, t_all, intr, states, TROptions(4), H=H, W=W, robust_loss="tukey")
                   for src in (shared, replicated)]
            assert all(torch.equal(a, b) for a, b in zip(*res))
        return
    for fn in (FB.fused_tr_level_batch, FB.fused_tr_level_batch_reference):
        with pytest.raises(error, match=what):
            fn(i0, geom, t_all, intr, states, TROptions(2), H=H, W=W)


def test_library_path_hashes_headers(tmp_path, monkeypatch):
    """A changed header (or source) names another library, so a stale
    build is never loaded; the build puts csrc/ on the include path."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    paths = [_build.library_path()]
    assert _build.library_path() == paths[0]
    for name in ("phovo_linearize.cuh", "fused_tr_batch.cu"):
        f = csrc / name
        f.write_text(f.read_text() + "\n// edited\n")
        paths.append(_build.library_path())
    assert len(set(paths)) == 3

    seen = []

    def fake_run(cmd, **kw):
        seen.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, "", "refused")

    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()
    # one nvcc per source, every one started
    assert all(cmd[cmd.index("-I") + 1] == str(csrc) for cmd in seen)
    assert sorted(Path(c).name for cmd in seen for c in cmd if c.endswith(".cu")) == [
        "fused_gn_batch.cu", "fused_lin.cu", "fused_tr_batch.cu", "ic_gn_batch.cu",
        "ic_precompute.cu", "prep_levels.cu",
    ]
    assert not list((tmp_path / "build").iterdir())  # nothing left behind
