"""The CUDA kernels (the Gauss-Newton and trust-region levels with their
loss and Jacobian variants, the bi-objective Gauss-Newton level, the one
linearization, and the inverse-compositional precompute and level)
against their plain torch versions, on the card; and the keyframe
back-end's bundle adjustment (plain torch) on the card against the CPU.

Needs an NVIDIA GPU and nvcc; skipped elsewhere. Run on the card with
    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py
(tests/conftest.py imports jax, which the port's machines
need not have). The kernel is held to the plain version, which the CPU
tests hold to phovo_tpu. Tolerance: states 2e-4 absolute and cost 1e-4
relative (pixel sums in another order; the Gauss-Newton level's cost at
the state the kernel linearized last), iterations and valid counts equal
(the per-pixel arithmetic is the same, built without contracted
multiply-adds). Nearest sampling runs 2 iterations: from the third on, the
states differ by enough (~1e-6) that a pixel within that distance of a
rounding boundary samples its neighbour in one version and not the other,
which moves the cost by ~5e-4 (measured on an H100). The trust-region
kernel is held to the same bounds, its max|J^T r| to 1e-3 relative over
budgets of 4 iterations and on pairs an early-exit case stops, and its
radius to 1e-4 relative over budgets of 4 iterations; longer runs near
float32 noise, where max|J^T r| is noise and rho (a ratio of noise-level
cost changes) halves or grows the radius by chance. Its stopping tests
are held by early-exit
cases whose tolerances chip_smoke.py's early_exit_tolerance sets at least
7% from every value the test reads, so both versions must stop where the
plain version's values predict. The inverse-compositional precompute's
J8 rows are held to 1e-6 (the same expressions) and its factor to 1e-4 of
its largest entry (the Gram's sums in another order); its level kernel to
the Gauss-Newton kernel's bounds, nearest over 2 iterations. The
bi-objective level (K-GN-bi) is held to the Gauss-Newton kernel's bounds
at B = 8 and B = 1 (its kernel adds each pixel's depth products into the
intensity's sums, the plain version sums the channels apart: another
order of the same float32 sums). The one-linearization kernel (K-LIN) is
held to its plain Gram within 1e-4 of each pair's largest entry, with
valid counts equal, at 96x128 and, split over lin_split(H, W) blocks a
pair, at 480x640 and 120x160; a pair alone gives its row of a batch bit
for bit, and every forced layout stays within the same bounds of one block
a pair.
"""

import functools
import importlib.util
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from phovo_tpu_torch.ops import fused_batch as FB
from phovo_tpu_torch.ops import pyramid as pyr
from phovo_tpu_torch.ops.camera import TUM_FR1, Intrinsics
from phovo_tpu_torch.ops.fused import fused_tr_level, pack_geometry, pack_target
from phovo_tpu_torch.solvers.trust_region import TROptions
from phovo_tpu_torch.utils.synthetic import make_sequence

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA GPU"),
]

INTR = Intrinsics(128.0, 128.0, 63.5, 47.5)
TESTS_OFF = dict(function_tolerance=1e-9, gradient_tolerance=1e-12, parameter_tolerance=1e-10)


def _chip_smoke():
    """chip_smoke.py as a module (it runs its phases only as a script)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("sampling,iterations,threshold", [
    ("nearest", 2, 0.0),
    ("bilinear", 8, 0.0),
    ("bilinear", 8, 200.0),
])
def test_kernel_matches_plain(sampling, iterations, threshold):
    """End states within 2e-4, iteration and valid counts equal, nothing
    band-masked; the cost of each pair's last linearization within 1e-4 of
    the plain version's cost at the same state: the kernel's state before
    that linearization (a run with one iteration less), linearized once by
    the plain version. Near convergence the float32 cost at two states
    ~1e-7 apart differs by more than 1e-4, and the plain version on the
    CPU and on the card differ by 1.35e-4 on the bilinear case (PERF.md),
    so the end costs of two runs are not held to 1e-4."""
    H, W = 96, 128
    I, D, _, _ = make_sequence(INTR, (H, W), 6)
    dev = torch.device("cuda")
    It = torch.from_numpy(np.stack(I)).to(dev)
    Dt = torch.from_numpy(np.stack(D)).to(dev)
    t_all = pack_target(It, pyr.scharr(It, "x", 0.0625), pyr.scharr(It, "y", 0.0625))
    packs = (It[:-1].reshape(5, -1).contiguous(), pack_geometry(Dt[:-1], INTR, 0.3, 5.0).contiguous(),
             t_all[1:].contiguous(), INTR)
    args = (*packs, torch.zeros((5, 6), device=dev), iterations, threshold, 1.0)
    before = FB.LAUNCHES
    k = FB.fused_gn_level_batch(*args, H=H, W=W, sampling=sampling)
    assert FB.LAUNCHES == before + 1
    p = FB.fused_gn_level_batch_reference(*args, H=H, W=W, sampling=sampling)
    assert FB.LAUNCHES == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(k.state, p.state, rtol=0, atol=2e-4)
    assert torch.equal(k.iterations, p.iterations)
    assert torch.equal(k.num_valid, p.num_valid)
    assert float(k.band_masked.abs().sum()) == 0.0
    # a pair that ran m iterations linearized last at its state after m - 1
    cost_there = torch.full_like(k.cost, float("nan"))
    for m in k.iterations.unique().tolist():
        prev = FB.fused_gn_level_batch(*args[:5], m - 1, threshold, 1.0, H=H, W=W, sampling=sampling)
        one = FB.fused_gn_level_batch_reference(*packs, prev.state, 1, 0.0, 1.0, H=H, W=W, sampling=sampling)
        cost_there = torch.where(k.iterations == m, one.cost, cost_there)
    torch.testing.assert_close(k.cost, cost_there, rtol=1e-4, atol=0)


def _packs(H=96, W=128, n=6):
    I, D, _, _ = make_sequence(INTR, (H, W), n)
    dev = torch.device("cuda")
    It = torch.from_numpy(np.stack(I)).to(dev)
    Dt = torch.from_numpy(np.stack(D)).to(dev)
    t_all = pack_target(It, pyr.scharr(It, "x", 0.0625), pyr.scharr(It, "y", 0.0625))
    init = torch.from_numpy(
        (np.random.default_rng(0).standard_normal((n - 1, 6)) * 1e-3).astype(np.float32)
    ).to(dev)
    return (
        It[:-1].reshape(n - 1, -1).contiguous(),
        pack_geometry(Dt[:-1], INTR, 0.3, 5.0).contiguous(),
        t_all[1:].contiguous(), INTR, init,
    ), (It, Dt, t_all)


@pytest.mark.parametrize("sampling,iterations", [
    ("bilinear", 4), ("bilinear", 12), ("nearest", 2),
])
def test_tr_kernel_matches_plain(sampling, iterations):
    args, _ = _packs()
    _assert_tr_kernel_matches_plain(args, TROptions(iterations, **TESTS_OFF), sampling, iterations <= 4)


@pytest.mark.parametrize("stop", list(TESTS_OFF))
def test_tr_kernel_stops_early_like_plain(stop):
    """Each stopping test set to stop pairs before chip_smoke.py's
    early-exit budget, away from its boundary: both versions stop after the
    predicted counts."""
    smoke = _chip_smoke()
    args, _ = _packs()
    n = smoke.EARLY_EXIT_ITERATIONS
    opts = TROptions(n, **TESTS_OFF)
    tol, stops = smoke.early_exit_tolerance(smoke.stop_values(FB, args, opts, 96, 128)[stop])
    k = _assert_tr_kernel_matches_plain(args, opts._replace(**{stop: tol}), "bilinear", stops < n)
    assert k.iterations.cpu().tolist() == stops.tolist()


def _assert_tr_kernel_matches_plain(args, opts, sampling, settled, **loss_kw):
    """settled: a bool or (B,) mask of the pairs short of convergence,
    whose max|J^T r| is compared too."""
    before = FB.TR_LAUNCHES
    k = FB.fused_tr_level_batch(*args, opts, H=96, W=128, sampling=sampling, **loss_kw)
    assert FB.TR_LAUNCHES == before + 1
    p = FB.fused_tr_level_batch_reference(*args, opts, H=96, W=128, sampling=sampling, **loss_kw)
    assert FB.TR_LAUNCHES == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(k.state, p.state, rtol=0, atol=2e-4)
    assert torch.equal(k.iterations, p.iterations)
    assert torch.equal(k.num_valid, p.num_valid)
    torch.testing.assert_close(k.cost, p.cost, rtol=1e-4, atol=0)
    settled = torch.as_tensor(settled, device=k.state.device).expand(k.state.shape[0])
    torch.testing.assert_close(k.gradient_norm[settled], p.gradient_norm[settled], rtol=1e-3, atol=0)
    if int(p.iterations.max()) <= 4 and bool(settled.all()):
        torch.testing.assert_close(k.radius, p.radius, rtol=1e-4, atol=0)
    assert float(k.band_masked.abs().sum()) == 0.0
    return k


def test_tr_kernel_single_pair_equals_batch():
    """B = 1 (the per-pair level, ops/fused.fused_tr_level) runs each pair
    through the same block code as the batch: the same bits."""
    args, (It, Dt, t_all) = _packs()
    opts = TROptions(6, 1e-4, 1e-3, 1e-6, 1e4, 1e8)
    batch = FB.fused_tr_level_batch(*args, opts, H=96, W=128)
    for j in range(args[0].shape[0]):
        one = fused_tr_level(It[j], Dt[j], t_all[j + 1], INTR, args[4][j], 0.3, 5.0, opts)
        for x, y in zip(one, batch):
            assert torch.equal(x, y[j])


# -- the loss and Jacobian variants -------------------------------------------

DELTAS = {"none": 0.1, "huber": 0.02, "cauchy": 0.02, "tukey": 0.1, "tdist": 0.1}


def _variant_packs(esm, H=96, W=128, n=6):
    """_packs with a bright occluder in every target (so the robust
    weights bite) and, for ESM, the source gradients as geometry rows."""
    I, D, _, _ = make_sequence(INTR, (H, W), n)
    I = np.stack(I)
    I[1:, 10:30, 70:100] = 0.95
    dev = torch.device("cuda")
    It = torch.from_numpy(I).to(dev)
    Dt = torch.from_numpy(np.stack(D)).to(dev)
    gx, gy = pyr.scharr(It, "x", 0.0625), pyr.scharr(It, "y", 0.0625)
    init = torch.from_numpy(
        (np.random.default_rng(0).standard_normal((n - 1, 6)) * 1e-3).astype(np.float32)
    ).to(dev)
    sg = (gx[:-1], gy[:-1]) if esm else None
    return (
        It[:-1].reshape(n - 1, -1).contiguous(),
        pack_geometry(Dt[:-1], INTR, 0.3, 5.0, sg).contiguous(),
        pack_target(It, gx, gy)[1:].contiguous(), INTR, init,
    )


@pytest.mark.parametrize("loss,esm,sampling,iterations", [
    ("huber", False, "bilinear", 8), ("cauchy", False, "bilinear", 8),
    ("tukey", False, "bilinear", 8), ("tdist", False, "bilinear", 8),
    ("none", True, "bilinear", 8), ("huber", True, "nearest", 2),
    ("tdist", True, "nearest", 2),
])
def test_gn_kernel_variants_match_plain(loss, esm, sampling, iterations):
    """K-GN with each loss and ESM against its plain version; tdist with a
    per-pair sigma in, 4 burn-in passes, and the sigma out."""
    args = _variant_packs(esm)
    kw = dict(H=96, W=128, sampling=sampling, robust_loss=loss, robust_delta=DELTAS[loss], esm=esm)
    if loss == "tdist":
        kw.update(robust_scale=torch.linspace(0.05, 0.2, 5, device="cuda"), tdist_burnin=4)
    before = FB.LAUNCHES
    k = FB.fused_gn_level_batch(*args, iterations, 0.0, 1.0, **kw)
    assert FB.LAUNCHES == before + 1
    p = FB.fused_gn_level_batch_reference(*args, iterations, 0.0, 1.0, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(k.state, p.state, rtol=0, atol=2e-4)
    assert torch.equal(k.iterations, p.iterations)
    assert torch.equal(k.num_valid, p.num_valid)
    torch.testing.assert_close(k.cost, p.cost, rtol=1e-4, atol=0)
    torch.testing.assert_close(k.robust_scale, p.robust_scale, rtol=1e-4, atol=0)


def test_gn_kernel_single_pair_equals_batch():
    """B = 1 (the per-pair level, ops/fused.fused_gn_level_packs) runs each
    pair through the same block code as the batch, per-pair sigma too: the
    same bits."""
    from phovo_tpu_torch.ops.fused import fused_gn_level_packs

    args = _variant_packs(True)
    scale = torch.linspace(0.05, 0.2, 5, device="cuda")
    kw = dict(H=96, W=128, sampling="bilinear", robust_loss="tdist", esm=True, tdist_burnin=4)
    batch = FB.fused_gn_level_batch(*args, 6, 0.0, 1.0, robust_scale=scale, **kw)
    for j in range(5):
        one = fused_gn_level_packs(
            args[0][j], args[1][j], args[2][j], INTR, args[4][j], 6, 0.0, 1.0,
            robust_scale=scale[j], **kw,
        )
        for x, y in zip(one, batch):
            assert torch.equal(x, y[j])


@pytest.mark.parametrize("loss", ["huber", "cauchy", "tukey"])
def test_tr_kernel_robust_losses_match_plain(loss):
    args = _variant_packs(False)
    before = FB.TR_LAUNCHES
    opts = TROptions(4, **TESTS_OFF)
    kw = dict(H=96, W=128, robust_loss=loss, robust_delta=0.05)
    k = FB.fused_tr_level_batch(*args, opts, **kw)
    assert FB.TR_LAUNCHES == before + 1
    p = FB.fused_tr_level_batch_reference(*args, opts, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(k.state, p.state, rtol=0, atol=2e-4)
    assert torch.equal(k.iterations, p.iterations)
    assert torch.equal(k.num_valid, p.num_valid)
    torch.testing.assert_close(k.cost, p.cost, rtol=1e-4, atol=0)
    torch.testing.assert_close(k.gradient_norm, p.gradient_norm, rtol=1e-3, atol=0)


@pytest.mark.parametrize("loss,esm,sampling", [
    ("none", False, "nearest"), ("huber", False, "bilinear"), ("cauchy", True, "nearest"),
    ("tukey", False, "bilinear"), ("tdist", True, "bilinear"),
])
def test_lin_kernel_matches_plain(loss, esm, sampling):
    """K-LIN's Gram within 1e-4 of its largest entry, the valid count and
    the band slot (always 0) equal."""
    args = _variant_packs(esm)
    kw = dict(H=96, W=128, sampling=sampling, robust_loss=loss, robust_delta=DELTAS[loss], esm=esm)
    before = FB.LIN_LAUNCHES
    k = FB.fused_lin_batch(*args, **kw)
    assert FB.LIN_LAUNCHES == before + 1
    p = FB.fused_lin_batch_reference(*args, **kw)
    torch.cuda.synchronize()
    scale = p.abs().amax(dim=(1, 2), keepdim=True)
    assert bool(((k - p).abs() <= 1e-4 * scale).all()), float(((k - p).abs() / scale).max())
    assert torch.equal(k[:, 7, 7], p[:, 7, 7])
    assert float(k[:, 6, 7].abs().sum()) == 0.0
    assert torch.equal(k, k.transpose(1, 2))


def test_analytic_object_api_launches_once_per_level():
    """PhotoconsistencyOdometryAnalytic on the card: one K-GN launch per
    active level (the pair's K-PREP launch beside them), the states of the
    plain per-pair route."""
    from unittest import mock

    from phovo_tpu_torch.models import analytic
    from phovo_tpu_torch.utils.config import PhovoConfig

    cfg = PhovoConfig(
        num_levels=3, blur_filter_sizes=(0,) * 3, gradient_scales=(0.0625,) * 3,
        max_iterations=(0, 4, 6), lambda_steps=(1.0,) * 3, min_gradient_norms=(0.0,) * 3,
        sampling="bilinear", robust_loss="tdist", gradient_at="esm",
    )
    I, D, _, _ = make_sequence(INTR, (96, 128), 2)
    vo = analytic.PhotoconsistencyOdometryAnalytic(cfg, device="cuda")
    vo.set_intrinsic_matrix([[INTR.fx, 0, INTR.cx], [0, INTR.fy, INTR.cy], [0, 0, 1]])
    vo.set_source_frame((I[0] * 255).astype(np.uint8), D[0])
    vo.set_target_frame((I[1] * 255).astype(np.uint8), D[1])
    before = FB.LAUNCHES
    k = vo.optimize()
    torch.cuda.synchronize()
    assert FB.LAUNCHES == before + 2
    with mock.patch.object(analytic, "fused_gn_level_batch", FB.fused_gn_level_batch_reference):
        p = vo.optimize()
    assert FB.LAUNCHES == before + 2
    torch.testing.assert_close(k.state, p.state, rtol=0, atol=2e-4)
    assert torch.equal(k.iterations, p.iterations)


# -- the inverse-compositional kernels ----------------------------------------


def _ic_frames(H=96, W=128, n=6):
    """n make_sequence frames on the card with the source Scharr gradients
    (scale 1/32, the IC backend's convention)."""
    I, D, _, _ = make_sequence(INTR, (H, W), n)
    dev = torch.device("cuda")
    It = torch.from_numpy(np.stack(I)).to(dev)
    Dt = torch.from_numpy(np.stack(D)).to(dev)
    return It, Dt, pyr.scharr(It, "x", 0.03125), pyr.scharr(It, "y", 0.03125)


def test_ic_precompute_kernel_matches_plain():
    from phovo_tpu_torch.ops import ic as IC

    frames = _ic_frames()
    before = IC.IC_PRE_LAUNCHES
    J8, L = IC.ic_precompute_batch(*frames, INTR, 0.3, 5.0)
    assert IC.IC_PRE_LAUNCHES == before + 1
    pJ8, pL = IC.ic_precompute_batch_reference(*frames, INTR, 0.3, 5.0)
    assert IC.IC_PRE_LAUNCHES == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(J8, pJ8, rtol=0, atol=1e-6)
    scale = pL.abs().amax(dim=1, keepdim=True)
    assert bool(((L - pL).abs() <= 1e-4 * scale).all()), float(((L - pL).abs() / scale).max())
    assert torch.equal(L.reshape(-1, 6, 6).triu(1), torch.zeros_like(L.reshape(-1, 6, 6)))


def _ic_level_args(n=6):
    """K-IC's inputs for n - 1 pairs at 96x128 (frame k to k + 1), the
    constants from the plain precompute."""
    from phovo_tpu_torch.ops import ic as IC

    It, Dt, gx, gy = _ic_frames(n=n)
    J8, L = IC.ic_precompute_batch_reference(It, Dt, gx, gy, INTR, 0.3, 5.0)
    geom = pack_geometry(Dt, INTR, 0.3, 5.0)
    eye = torch.eye(4, device="cuda").repeat(n - 1, 1, 1)
    return (eye, geom[:-1].contiguous(), J8[:-1].contiguous(), L[:-1].contiguous(), It[1:].contiguous(), INTR)


def _assert_ic_kernel_matches_plain(args, iterations, threshold, sampling):
    from phovo_tpu_torch.ops import ic_batch as ICB

    before = ICB.IC_LAUNCHES
    k = ICB.ic_gn_level_batch(*args, iterations, threshold, 1.0, H=96, W=128, sampling=sampling)
    assert ICB.IC_LAUNCHES == before + 1
    p = ICB.ic_gn_level_batch_reference(*args, iterations, threshold, 1.0, H=96, W=128, sampling=sampling)
    assert ICB.IC_LAUNCHES == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(k.T, p.T, rtol=0, atol=2e-4)
    assert torch.equal(k.iterations, p.iterations)
    assert torch.equal(k.num_valid, p.num_valid)
    torch.testing.assert_close(k.cost, p.cost, rtol=1e-4, atol=0)
    assert float(k.band_masked.abs().sum()) == 0.0
    return k


@pytest.mark.parametrize("sampling,iterations", [("nearest", 2), ("bilinear", 8)])
def test_ic_kernel_matches_plain(sampling, iterations):
    _assert_ic_kernel_matches_plain(_ic_level_args(), iterations, 0.0, sampling)


@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
def test_ic_kernel_stops_early_like_plain(sampling):
    """A gradient-norm threshold at least 7% from every ||g|| the plain
    version reads before a stop: both versions stop after the predicted
    counts."""
    from phovo_tpu_torch.ops import ic_batch as ICB

    smoke = _chip_smoke()
    args, n = _ic_level_args(), 2
    gnorms = [torch.full((5,), float("inf"), dtype=torch.float64)]
    gnorms += [
        ICB.ic_gn_level_batch_reference(*args, m, 0.0, 1.0, H=96, W=128, sampling=sampling).gradient_norm.double().cpu()
        for m in range(1, n + 1)
    ]
    tol, stops = smoke.early_exit_tolerance(torch.stack(gnorms))
    k = _assert_ic_kernel_matches_plain(args, n, tol, sampling)
    assert k.iterations.cpu().tolist() == stops.tolist()


def test_ic_kernel_single_pair_equals_batch():
    """B = 1 (the per-pair level, ops/ic.ic_gn_level) runs each pair through
    the same block code as the batch: the same bits."""
    from phovo_tpu_torch.ops import ic as IC
    from phovo_tpu_torch.ops import ic_batch as ICB

    Ts, geom, J8, L, t_i, intr = _ic_level_args()
    batch = ICB.ic_gn_level_batch(Ts, geom, J8, L, t_i, intr, 6, 0.0, 1.0, H=96, W=128, sampling="bilinear")
    for j in range(Ts.shape[0]):
        one = IC.ic_gn_level(Ts[j], geom[j], J8[j], L[j], t_i[j], intr, 6, 0.0, 1.0, "bilinear")
        for x, y in zip(one, batch):
            assert torch.equal(x, y[j])


def test_ic_object_api_launches_once_per_level():
    """PhotoconsistencyOdometryIC on the card: one K-ICpre and one K-IC
    launch per active level, the states of the plain per-pair route."""
    from unittest import mock

    from phovo_tpu_torch.models import ic
    from phovo_tpu_torch.ops import ic as IC
    from phovo_tpu_torch.ops import ic_batch as ICB
    from phovo_tpu_torch.utils.config import PhovoConfig

    cfg = PhovoConfig(
        num_levels=3, blur_filter_sizes=(0,) * 3, gradient_scales=(0.03125,) * 3,
        max_iterations=(0, 4, 6), lambda_steps=(1.0,) * 3, min_gradient_norms=(0.0,) * 3,
        sampling="bilinear",
    )
    I, D, _, _ = make_sequence(INTR, (96, 128), 2)
    vo = ic.PhotoconsistencyOdometryIC(cfg)
    assert vo.device.type == "cuda"
    vo.set_intrinsic_matrix([[INTR.fx, 0, INTR.cx], [0, INTR.fy, INTR.cy], [0, 0, 1]])
    vo.set_source_frame((I[0] * 255).astype(np.uint8), D[0])
    vo.set_target_frame((I[1] * 255).astype(np.uint8), D[1])
    before = (IC.IC_PRE_LAUNCHES, ICB.IC_LAUNCHES)
    k = vo.optimize()
    torch.cuda.synchronize()
    assert (IC.IC_PRE_LAUNCHES, ICB.IC_LAUNCHES) == (before[0] + 2, before[1] + 2)
    with mock.patch.object(IC, "ic_precompute_batch", IC.ic_precompute_batch_reference), \
            mock.patch.object(ic, "ic_gn_level_batch", ICB.ic_gn_level_batch_reference):
        p = vo.optimize()
    assert (IC.IC_PRE_LAUNCHES, ICB.IC_LAUNCHES) == (before[0] + 2, before[1] + 2)
    torch.testing.assert_close(k.state, p.state, rtol=0, atol=2e-4)
    assert torch.equal(k.iterations, p.iterations)


# -- the bi-objective level (K-GN-bi) -------------------------------------------


def _bi_args(n=9, H=96, W=128):
    """K-GN-bi's inputs for n - 1 pairs of make_sequence frames with an
    occluder in every target: six-channel targets, the targets' gains and
    small seeded init states."""
    I, D, _, _ = make_sequence(INTR, (H, W), n)
    I = np.stack(I)
    I[1:, 10:30, 70:100] = 0.95
    dev = torch.device("cuda")
    It = torch.from_numpy(I).to(dev)
    Dt = torch.from_numpy(np.stack(D)).to(dev)
    dn = Dt * (1.0 / 5.0)
    t6 = pack_target(It, pyr.scharr(It, "x", 0.0625), pyr.scharr(It, "y", 0.0625),
                     (Dt, pyr.scharr(dn, "x", 0.0625), pyr.scharr(dn, "y", 0.0625)))
    init = torch.from_numpy(
        (np.random.default_rng(0).standard_normal((n - 1, 6)) * 1e-3).astype(np.float32)
    ).to(dev)
    gains = It.mean(dim=(1, 2)) / Dt.mean(dim=(1, 2))
    return (
        It[:-1].reshape(n - 1, -1).contiguous(), pack_geometry(Dt[:-1], INTR, 0.3, 5.0).contiguous(),
        t6[1:].contiguous(), INTR, init,
    ), gains[1:].contiguous()


@pytest.mark.parametrize("loss,sampling,iterations", [
    ("none", "bilinear", 8), ("huber", "bilinear", 8), ("cauchy", "bilinear", 8),
    ("tukey", "bilinear", 8), ("none", "nearest", 2), ("tukey", "nearest", 2),
])
def test_bi_kernel_matches_plain(loss, sampling, iterations):
    """K-GN-bi at B = 8 against its plain version. Nearest costs are held
    after one iteration (both versions linearize at the same state): after
    the second, a depth sample that flips between the two states moves a
    pair's cost by a whole depth residual (1.19e-4 relative with 'none';
    H100)."""
    args, gains = _bi_args()
    kw = dict(H=96, W=128, sampling=sampling, robust_loss=loss, robust_delta=DELTAS[loss], depth_gains=gains)
    before = FB.LAUNCHES
    k = FB.fused_gn_level_batch(*args, iterations, 0.0, 1.0, **kw)
    assert FB.LAUNCHES == before + 1
    p = FB.fused_gn_level_batch_reference(*args, iterations, 0.0, 1.0, **kw)
    assert FB.LAUNCHES == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(k.state, p.state, rtol=0, atol=2e-4)
    assert torch.equal(k.iterations, p.iterations)
    assert torch.equal(k.num_valid, p.num_valid)
    if sampling == "nearest":
        k = FB.fused_gn_level_batch(*args, 1, 0.0, 1.0, **kw)
        p = FB.fused_gn_level_batch_reference(*args, 1, 0.0, 1.0, **kw)
    torch.testing.assert_close(k.cost, p.cost, rtol=1e-4, atol=0)
    assert float(k.band_masked.abs().sum()) == 0.0


def test_bi_kernel_single_pair_matches_plain_and_batch():
    """B = 1 (the per-pair level, B4's port: ops/fused.fused_gn_level_packs
    with bi=True): each pair against its plain version at B = 1, and the
    same bits as its block in the batch."""
    from phovo_tpu_torch.ops import fused as fused_ops

    args, gains = _bi_args()
    kw = dict(H=96, W=128, sampling="bilinear", robust_loss="cauchy", robust_delta=0.02)
    batch = FB.fused_gn_level_batch(*args, 6, 0.0, 1.0, depth_gains=gains, **kw)
    for j in range(gains.shape[0]):
        pair = (args[0][j], args[1][j], args[2][j], INTR, args[4][j], 6, 0.0, 1.0)
        one = fused_ops.fused_gn_level_packs(*pair, bi=True, depth_gain=gains[j], **kw)
        with mock.patch.object(fused_ops, "fused_gn_level_batch", FB.fused_gn_level_batch_reference):
            plain = fused_ops.fused_gn_level_packs(*pair, bi=True, depth_gain=gains[j], **kw)
        torch.testing.assert_close(one[0], plain[0], rtol=0, atol=2e-4)
        assert int(one[1]) == int(plain[1]) and float(one[4]) == float(plain[4])
        for x, y in zip(one, batch):
            assert torch.equal(x, y[j])


def test_bi_kernel_refuses_esm_and_tdist_before_a_launch():
    args, gains = _bi_args(n=3)
    before = FB.LAUNCHES
    with pytest.raises(ValueError, match="photometric-only"):
        FB.fused_gn_level_batch(*args, 2, 0.0, 1.0, H=96, W=128, robust_loss="tdist", depth_gains=gains)
    assert FB.LAUNCHES == before


def test_bi_object_api_launches_once_per_level():
    """PhotoconsistencyOdometryBiObjective on the card: one K-GN-bi launch
    per active level, the states of the plain per-pair route."""
    from phovo_tpu_torch.models import analytic, biobjective
    from phovo_tpu_torch.utils.config import PhovoConfig

    cfg = PhovoConfig(
        num_levels=3, blur_filter_sizes=(0,) * 3, gradient_scales=(0.0625,) * 3,
        max_iterations=(0, 4, 6), lambda_steps=(1.0,) * 3, min_gradient_norms=(0.0,) * 3,
        sampling="bilinear", robust_loss="huber", robust_delta=0.02,
    )
    I, D, _, _ = make_sequence(INTR, (96, 128), 2)
    vo = biobjective.PhotoconsistencyOdometryBiObjective(cfg)
    assert vo.device.type == "cuda"
    vo.set_intrinsic_matrix([[INTR.fx, 0, INTR.cx], [0, INTR.fy, INTR.cy], [0, 0, 1]])
    vo.set_source_frame((I[0] * 255).astype(np.uint8), D[0])
    vo.set_target_frame((I[1] * 255).astype(np.uint8), D[1])
    before = FB.LAUNCHES
    k = vo.optimize()
    torch.cuda.synchronize()
    assert FB.LAUNCHES == before + 2
    with mock.patch.object(analytic, "fused_gn_level_batch", FB.fused_gn_level_batch_reference):
        p = vo.optimize()
    assert FB.LAUNCHES == before + 2
    torch.testing.assert_close(k.state, p.state, rtol=0, atol=2e-4)
    assert torch.equal(k.iterations, p.iterations)


# -- the shared-source modes, the multi-stream level, the keyframe path -------


def _shared_args(esm, n=7, H=96, W=128):
    """ONE source for every pair, as in keyframe tracking: the middle of n
    make_sequence frames (the keyframe) against the other n - 1, at most
    n // 2 frames away, from small seeded init states. Returns the shared
    (1, N) and (1, GR, N) packs' arguments and the same with the pack
    repeated n - 1 times."""
    I, D, _, _ = make_sequence(INTR, (H, W), n)
    It = torch.from_numpy(np.stack(I)).cuda()
    Dt = torch.from_numpy(np.stack(D)).cuda()
    gx, gy = pyr.scharr(It, "x", 0.0625), pyr.scharr(It, "y", 0.0625)
    kf = n // 2
    targets = [k for k in range(n) if k != kf]
    B = len(targets)
    i0 = It[kf].reshape(1, -1).contiguous()
    geom = pack_geometry(Dt[kf:kf + 1], INTR, 0.3, 5.0, (gx[kf:kf + 1], gy[kf:kf + 1]) if esm else None).contiguous()
    t_all = pack_target(It, gx, gy)[targets].contiguous()
    init = torch.from_numpy((np.random.default_rng(0).standard_normal((B, 6)) * 1e-3).astype(np.float32)).cuda()
    return (i0, geom, t_all, INTR, init), (i0.repeat(B, 1), geom.repeat(B, 1, 1), t_all, INTR, init)


@pytest.mark.parametrize("loss,esm,sampling,iterations", [
    ("none", False, "bilinear", 8), ("huber", False, "bilinear", 8), ("tukey", False, "nearest", 2),
    ("none", True, "bilinear", 8), ("cauchy", True, "nearest", 2), ("tdist", False, "bilinear", 8),
])
def test_gn_kernel_shared_source_matches_plain_and_replicated(loss, esm, sampling, iterations):
    """K-GN with one source pack read by every pair: the bits of the
    replicated launch, and the plain version's results within the bounds
    above."""
    shared, replicated = _shared_args(esm)
    kw = dict(H=96, W=128, sampling=sampling, robust_loss=loss, robust_delta=DELTAS[loss], esm=esm)
    before = FB.LAUNCHES
    k = FB.fused_gn_level_batch(*shared, iterations, 0.0, 1.0, **kw)
    r = FB.fused_gn_level_batch(*replicated, iterations, 0.0, 1.0, **kw)
    assert FB.LAUNCHES == before + 2
    p = FB.fused_gn_level_batch_reference(*shared, iterations, 0.0, 1.0, **kw)
    torch.cuda.synchronize()
    for x, y in zip(k, r):
        assert torch.equal(x, y)
    torch.testing.assert_close(k.state, p.state, rtol=0, atol=2e-4)
    assert torch.equal(k.iterations, p.iterations)
    assert torch.equal(k.num_valid, p.num_valid)
    torch.testing.assert_close(k.cost, p.cost, rtol=1e-4, atol=0)


@pytest.mark.parametrize("loss,iterations", [("none", 4), ("huber", 4), ("tukey", 12)])
def test_tr_kernel_shared_source_matches_plain_and_replicated(loss, iterations):
    """K-TR with one source pack read by every pair: the bits of the
    replicated launch, and the plain version within the trust-region
    bounds above (max|J^T r| and the radius over budgets of 4)."""
    shared, replicated = _shared_args(False)
    opts = TROptions(iterations, **TESTS_OFF)
    kw = dict(robust_loss=loss, robust_delta=0.05)
    before = FB.TR_LAUNCHES
    r = FB.fused_tr_level_batch(*replicated, opts, H=96, W=128, **kw)
    k = _assert_tr_kernel_matches_plain(shared, opts, "bilinear", iterations <= 4, **kw)
    assert FB.TR_LAUNCHES == before + 2
    for x, y in zip(k, r):
        assert torch.equal(x, y)


@pytest.mark.parametrize("loss,esm,sampling,iterations", [
    ("none", False, "bilinear", 8), ("huber", True, "nearest", 2),
])
def test_multi_level_is_one_kgn_launch(loss, esm, sampling, iterations):
    """fused_gn_level_multi (B7): one K-GN launch for the S streams, the
    bits of fused_gn_level_batch on the same packs, and its plain version
    within the bounds above."""
    from phovo_tpu_torch.ops import fused as fused_ops

    I, D, _, _ = make_sequence(INTR, (96, 128), 9)
    It = torch.from_numpy(np.stack(I)).cuda()
    Dt = torch.from_numpy(np.stack(D)).cuda()
    gx, gy = pyr.scharr(It, "x", 0.0625), pyr.scharr(It, "y", 0.0625)
    sg = (gx[:-1], gy[:-1]) if esm else None
    tgt = torch.cat([It[1:], gx[1:], gy[1:]], dim=-2)
    init = torch.zeros((8, 6), device="cuda")
    args = (It[:-1], Dt[:-1], tgt, INTR, init, 0.3, 5.0, iterations, 0.0, 1.0, sampling, loss, DELTAS[loss], sg)
    before = (FB.LAUNCHES, fused_ops.MULTI_LAUNCHES)
    k = fused_ops.fused_gn_level_multi(*args)
    assert (FB.LAUNCHES, fused_ops.MULTI_LAUNCHES) == (before[0] + 1, before[1] + 1)
    p = fused_ops.fused_gn_level_multi_reference(*args)
    b = FB.fused_gn_level_batch(
        It[:-1].reshape(8, -1).contiguous(), pack_geometry(Dt[:-1], INTR, 0.3, 5.0, sg).contiguous(),
        pack_target(It, gx, gy)[1:].contiguous(), INTR, init, iterations, 0.0, 1.0, H=96, W=128,
        sampling=sampling, robust_loss=loss, robust_delta=DELTAS[loss], esm=esm,
    )
    torch.cuda.synchronize()
    for x, y in zip(k, b):
        assert torch.equal(x, y)
    torch.testing.assert_close(k.state, p.state, rtol=0, atol=2e-4)
    assert torch.equal(k.iterations, p.iterations)


def test_align_batch_gives_align_analytic_bits():
    """align_batch on the card: each pair the bits of align_analytic on it
    alone (one K-GN launch per active level for the batch)."""
    from phovo_tpu_torch.models.analytic import align_analytic
    from phovo_tpu_torch.parallel.batch import align_batch
    from phovo_tpu_torch.utils.config import PhovoConfig

    cfg = PhovoConfig(
        num_levels=3, blur_filter_sizes=(0,) * 3, gradient_scales=(0.0625,) * 3,
        max_iterations=(0, 4, 6), lambda_steps=(1.0,) * 3, min_gradient_norms=(0.0,) * 3,
        sampling="bilinear", robust_loss="tdist", gradient_at="esm",
    )
    I, D, _, _ = make_sequence(INTR, (96, 128), 5)
    It = torch.from_numpy((np.stack(I) * 255).astype(np.uint8)).cuda()
    Dt = torch.from_numpy(np.stack(D)).cuda()
    init = torch.from_numpy((np.random.default_rng(1).standard_normal((4, 6)) * 1e-3).astype(np.float32)).cuda()
    before = FB.LAUNCHES
    batch = align_batch(It[:-1], Dt[:-1], It[1:], Dt[1:], INTR, init, cfg, use_fused=True)
    assert FB.LAUNCHES == before + 2
    for j in range(4):
        one = align_analytic(It[j], Dt[j], It[j + 1], Dt[j + 1], INTR, init[j], cfg)
        for x, y in zip(one, batch):
            assert torch.equal(x, y[j])


def test_analytic_pair_is_one_k_prep_and_one_k_gn_launch_a_level():
    """align_analytic on a VGA pair of config_5_level_optimization_analytic:
    one K-PREP launch and one K-GN launch per active level, the bits of
    align_pairs_levelmajor at B = 1 on the torch chain's packs of the
    pair."""
    from phovo_tpu_torch.models import analytic
    from phovo_tpu_torch.ops import prep
    from phovo_tpu_torch.utils.config import load_builtin
    from phovo_tpu_torch.utils.synthetic import make_pair

    cfg = load_builtin("config_5_level_optimization_analytic")
    I0, D0, I1, D1, _ = make_pair(TUM_FR1, (480, 640))
    si, ti = (torch.from_numpy((x * 255).astype(np.uint8)).cuda() for x in (I0, I1))
    sd, td = (torch.from_numpy(np.asarray(x, np.float32)).cuda() for x in (D0, D1))
    init = torch.tensor([0.004, -0.003, 0.002, 0.001, -0.002, 0.0015], device="cuda")
    before = (prep.PREP_LAUNCHES, prep.PREP_TORCH_CALLS, FB.LAUNCHES)
    res = analytic.align_analytic(si, sd, ti, td, TUM_FR1, init, cfg)
    torch.cuda.synchronize()
    active = sum(n > 0 for n in cfg.max_iterations)
    assert (prep.PREP_LAUNCHES, prep.PREP_TORCH_CALLS, FB.LAUNCHES) == (before[0] + 1, before[1], before[2] + active)
    src = prep.prep_levels_torch(prep.device_unit_intensity(si), sd, TUM_FR1, cfg, targets=False)
    tgt = prep.prep_levels_torch(prep.device_unit_intensity(ti), None, None, cfg)
    packs = {level: (i0[None], geom[None], tgt[level][2][None]) for level, (i0, geom, _) in src.items()}
    want = analytic.align_pairs_levelmajor(packs, (480, 640), TUM_FR1, cfg, init.reshape(1, 6))
    for x, y in zip(res, want):
        assert torch.equal(x, y[0])


def test_keyframe_run_chunked_on_the_card():
    """KeyframeVisualOdometry.run_chunked on the card: one shared-source
    K-GN launch per active level a chunk dispatch, the closures through
    K-GN, and the keyframes, edges and closures of the plain versions.
    The plain run is plain throughout: every K-GN call of the models
    layer, the single pairs of align_analytic (the serial scan, the
    closures) included, goes through analytic.fused_gn_level_batch, the
    name it patches."""
    from phovo_tpu_torch.datasets.tum import RGBDFrame
    from phovo_tpu_torch.models import analytic
    from phovo_tpu_torch.models import keyframe
    from phovo_tpu_torch.ops import se3
    from phovo_tpu_torch.utils.config import PhovoConfig
    from phovo_tpu_torch.utils.synthetic import render_plane

    cfg = PhovoConfig(
        num_levels=2, blur_filter_sizes=(0, 0), gradient_scales=(0.0625, 0.0625),
        max_iterations=(10, 12), lambda_steps=(1.0, 1.0), min_gradient_norms=(1e-10, 1e-10),
        sampling="bilinear",
    )
    xs = np.concatenate([np.linspace(0, 0.24, 5), np.linspace(0.24, 0.02, 4)])
    frames = []
    for k, x in enumerate(xs):
        I, D = render_plane(INTR, (96, 128), se3.pose_matrix_np([x, 0.01 * np.sin(k), 0.0, 0.05 * x, 0.0, 0.0]))
        frames.append(RGBDFrame(float(k), float(k), (I * 255).astype(np.uint8), D))

    def run():
        vo = analytic.PhotoconsistencyOdometryAnalytic(cfg)
        vo.set_intrinsic_matrix([[INTR.fx, 0, INTR.cx], [0, INTR.fy, INTR.cy], [0, 0, 1]])
        kvo = keyframe.KeyframeVisualOdometry(vo, kf_translation=0.08, kf_rotation=0.1, loop_radius=0.15,
                                              loop_min_gap=2, loop_weight=50.0)
        tracked = list(kvo.run_chunked(frames, chunk=4))
        return kvo, kvo.finalize(iterations=8)

    FB.LAUNCHES = 0
    kern, tk = run()
    torch.cuda.synchronize()
    assert FB.LAUNCHES > 0
    with mock.patch.object(analytic, "fused_gn_level_batch", FB.fused_gn_level_batch_reference):
        plain, tp = run()
    assert [k.frame_index for k in kern.keyframes] == [k.frame_index for k in plain.keyframes]
    assert [(i, j) for i, j, _ in kern.odometry_edges] == [(i, j) for i, j, _ in plain.odometry_edges]
    assert [(c.from_kf, c.to_kf) for c in kern.loop_closures] == [(c.from_kf, c.to_kf) for c in plain.loop_closures]
    assert len(kern.loop_closures) >= 1
    for a, b in zip(tk, tp):
        np.testing.assert_allclose(a.pose, b.pose, atol=1e-4)


# -- the cluster layout: one pair over cluster_size(H, W) blocks --------------

STATE_ATOL = 2e-4
VGA_LEVELS = {0: (480, 640), 2: (120, 160)}
# the C entries, by kernel
ENTRY = {"tr": "phovo_fused_tr_level_batch", "gn": "phovo_fused_gn_level_batch", "bi": "phovo_fused_gn_level_batch"}


@functools.cache
def _vga_packs(bi):
    """Per-frame packs at levels 0 and 2 of 257 synthetic VGA frames
    (make_pair's two frames alternated, as chip_smoke.py's timing
    workload), photometric or bi-objective."""
    from phovo_tpu_torch.models.analytic import prep_frame_analytic
    from phovo_tpu_torch.models.biobjective import prep_frame_biobjective
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.utils.config import PhovoConfig
    from phovo_tpu_torch.utils.synthetic import make_pair

    cfg = PhovoConfig(num_levels=3, blur_filter_sizes=(0,) * 3, gradient_scales=(0.0625,) * 3,
                      max_iterations=(1,) * 3, lambda_steps=(1.0,) * 3, min_gradient_norms=(0.0,) * 3)
    I0, D0, I1, D1, _ = make_pair(TUM_FR1, (480, 640))
    Is = torch.from_numpy(np.stack([I0, I1] * 129)[:257]).cuda()
    Ds = torch.from_numpy(np.stack([D0, D1] * 129)[:257]).cuda()
    prep = (prep_frame_biobjective if bi else prep_frame_analytic)(Is, Ds, TUM_FR1, cfg)
    return {level: prep[level] for level in VGA_LEVELS}


def _vga_call(kernel, level, B, shared=False, seed=0):
    """(args, kw) of the wrapper for B pairs (frame k to k + 1) at a VGA
    level from small seeded states: K-TR 4 iterations with its stopping
    tests off, K-GN and K-GN-bi ('bi') 4 bilinear iterations. shared: frame
    0's pack is every pair's source (K-TR and K-GN only)."""
    from phovo_tpu_torch.ops.camera import TUM_FR1

    i0, geom, t_all, *gains = _vga_packs(kernel == "bi")[level]
    src = slice(0, 1) if shared else slice(0, B)
    init = torch.from_numpy((np.random.default_rng(seed).standard_normal((B, 6)) * 1e-3).astype(np.float32)).cuda()
    H, W = VGA_LEVELS[level]
    packs = (i0[src].contiguous(), geom[src].contiguous(), t_all[1:B + 1].contiguous(), TUM_FR1.at_level(level), init)
    if kernel == "tr":
        return (*packs, TROptions(4, **TESTS_OFF)), dict(H=H, W=W)
    kw = dict(H=H, W=W, sampling="bilinear")
    if kernel == "bi":
        kw["depth_gains"] = gains[0][1:B + 1].contiguous()
    return (*packs, 4, 0.0, 1.0), kw


def _wrapper(kernel):
    return FB.fused_tr_level_batch if kernel == "tr" else FB.fused_gn_level_batch


def _plain_in_chunks(kernel, args, kw, chunk=64):
    """The plain version's result (state, iterations, num_valid), run on at
    most `chunk` pairs at a time (each pair's result is its own)."""
    plain = FB.fused_tr_level_batch_reference if kernel == "tr" else FB.fused_gn_level_batch_reference
    B = args[2].shape[0]
    shared = args[0].shape[0] == 1 and B > 1
    outs = []
    for lo in range(0, B, chunk):
        sl = slice(lo, lo + chunk)
        src = (args[0], args[1]) if shared else (args[0][sl], args[1][sl])
        kw_sl = dict(kw, depth_gains=kw["depth_gains"][sl]) if "depth_gains" in kw else kw
        res = plain(*src, args[2][sl], args[3], args[4][sl], *args[5:], **kw_sl)
        outs.append((res.state, res.iterations, res.num_valid))
        torch.cuda.empty_cache()
    return SimpleNamespace(**dict(zip(("state", "iterations", "num_valid"), (torch.cat(x) for x in zip(*outs)))))


def _assert_valid_counts(kernel, args, kw, k, p, run_k, run_p):
    """Valid counts equal, or apart only by pixels whose warp crosses the
    image edge between the two runs' states (chip_smoke.explain_valid_diff:
    states ~1e-7 apart move such a pixel by less than 1e-3 px) at the last
    linearization: K-TR's final state, K-GN's one iteration before its end.
    run_k, run_p(args) rerun the two versions."""
    if torch.equal(k.num_valid, p.num_valid):
        return
    if kernel != "tr":
        before = (*args[:5], args[5] - 1, *args[6:])
        k = SimpleNamespace(state=run_k(before).state, num_valid=k.num_valid)
        p = SimpleNamespace(state=run_p(before).state, num_valid=p.num_valid)
    _chip_smoke().explain_valid_diff(FB, args[1], args[3], kw["H"], kw["W"], k, p, f"{kernel} valid counts")


@pytest.mark.parametrize("layout", ["alone", "shared", "batch"])
@pytest.mark.parametrize("level", sorted(VGA_LEVELS))
@pytest.mark.parametrize("kernel", ["tr", "gn", "bi"])
def test_cluster_kernels_match_plain_at_vga(kernel, level, layout):
    """K-TR, K-GN and K-GN-bi in their cluster layout against the plain
    versions at 480x640 and 120x160: a pair alone (B = 1), 16 pairs of one
    shared source (16 pairs of their own for K-GN-bi, which takes no
    shared source) and 256 pairs. States within STATE_ATOL, iteration
    counts equal, valid counts equal but for edge pixels."""
    B = {"alone": 1, "shared": 16, "batch": 256}[layout]
    args, kw = _vga_call(kernel, level, B, shared=layout == "shared" and kernel != "bi")
    k = _wrapper(kernel)(*args, **kw)
    p = _plain_in_chunks(kernel, args, kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(k.state, p.state, rtol=0, atol=STATE_ATOL)
    assert torch.equal(k.iterations, p.iterations)
    _assert_valid_counts(kernel, args, kw, k, p, lambda a: _wrapper(kernel)(*a, **kw),
                         lambda a: _plain_in_chunks(kernel, a, kw))


def _entry_launch(kernel, args, kw, cluster):
    """One launch through the C entry with `cluster` blocks a pair: (the
    CUDA error, the result's state, iterations and num_valid)."""
    from phovo_tpu_torch.ops import _build

    make = FB._tr_launch_args if kernel == "tr" else FB._gn_launch_args
    values, (states, diag, *_) = make(*args, **kw, stream=torch.cuda.current_stream().cuda_stream, cluster=cluster)
    err = getattr(_build.library(), ENTRY[kernel])(*values)
    torch.cuda.synchronize()
    # diag's rows: [it, ..., nvalid (column 3), ...] in both kernels
    return err, SimpleNamespace(state=states, iterations=diag[:, 0], num_valid=diag[:, 3])


@pytest.mark.parametrize("level", sorted(VGA_LEVELS))
@pytest.mark.parametrize("kernel", ["tr", "gn", "bi"])
def test_every_cluster_size_matches_one_block(kernel, level):
    """Every cluster size forced through the C entry (16 where the card
    schedules it; a refusal must be cudaErrorInvalidClusterSize, 912)
    against one block a pair, on 16 pairs: states within STATE_ATOL,
    iteration counts equal, valid counts equal but for edge pixels."""
    args, kw = _vga_call(kernel, level, 16, shared=kernel != "bi")
    err, base = _entry_launch(kernel, args, kw, 1)
    assert err == 0
    for c in (2, 4, 8, 16):
        err, res = _entry_launch(kernel, args, kw, c)
        if c == 16 and err == 912:
            continue
        assert err == 0, (c, err)
        torch.testing.assert_close(res.state, base.state, rtol=0, atol=STATE_ATOL)
        assert torch.equal(res.iterations, base.iterations), c
        _assert_valid_counts(kernel, args, kw, res, base, lambda a: _entry_launch(kernel, a, kw, c)[1],
                             lambda a: _entry_launch(kernel, a, kw, 1)[1])


@pytest.mark.parametrize("kernel", ["tr", "gn", "bi"])
def test_pair_alone_gives_its_bits_in_a_256_pair_launch(kernel):
    """At 480x640 a pair alone gives the bits it has inside a 256-pair
    launch: the cluster size is the level's, whatever B."""
    args, kw = _vga_call(kernel, 0, 256)
    batch = _wrapper(kernel)(*args, **kw)
    for j in (0, 1, 128, 255):
        one_args = (args[0][j:j + 1], args[1][j:j + 1], args[2][j:j + 1], args[3], args[4][j:j + 1], *args[5:])
        one_kw = dict(kw, depth_gains=kw["depth_gains"][j:j + 1]) if "depth_gains" in kw else kw
        one = _wrapper(kernel)(*one_args, **one_kw)
        for x, y in zip(one, batch):
            assert torch.equal(x, y[j:j + 1]), j


@pytest.mark.parametrize("kernel", ["tr", "gn"])
def test_unschedulable_cluster_raises(kernel, monkeypatch):
    """A cluster the card cannot schedule (32 blocks, above Hopper's 16)
    raises through the wrapper and counts no launch; there is no retry
    with smaller clusters, and the next launch is unaffected."""
    args, kw = _vga_call(kernel, 2, 4)
    ok = _wrapper(kernel)(*args, **kw)
    before = (FB.LAUNCHES, FB.TR_LAUNCHES)
    monkeypatch.setattr(FB, "cluster_size", lambda H, W: 32)
    with pytest.raises(RuntimeError, match="launch failed: CUDA error"):
        _wrapper(kernel)(*args, **kw)
    assert (FB.LAUNCHES, FB.TR_LAUNCHES) == before
    monkeypatch.undo()
    again = _wrapper(kernel)(*args, **kw)
    for x, y in zip(ok, again):
        assert torch.equal(x, y)


# -- the cluster layout of the inverse-compositional kernels ------------------


IC_LEVELS = {0: (480, 640), 2: (120, 160), 3: (60, 80)}
IC_SIZES = (1, 2, 4, 8, 16)
IC_ENTRY = {"ic": "phovo_ic_gn_level_batch", "icpre": "phovo_ic_precompute"}
IC_ITERATIONS = 4


@functools.cache
def _ic_vga():
    """chip_smoke.py's timing frames (257 synthetic VGA frames, make_pair's
    two alternated) and their IC products at all five levels: (prep,
    K-ICpre's inputs), chip_smoke.ic_timing_prep."""
    smoke = _chip_smoke()
    return smoke.ic_timing_prep(*smoke.timing_frames(torch.device("cuda")))


def _ic_call(kernel, level, B):
    """(args, kw) of the wrapper at a VGA level: K-ICpre on the first B
    frames, K-IC on the first B pairs (frame k to k + 1) from the identity,
    IC_ITERATIONS bilinear iterations."""
    from phovo_tpu_torch.ops.camera import TUM_FR1

    prep, pre = _ic_vga()
    if kernel == "icpre":
        return (*(x[:B] for x in pre[level][:4]), *pre[level][4:]), {}
    geom, J8, L, img = prep[level]
    H, W = img.shape[1:]
    Ts = torch.eye(4, device="cuda").repeat(B, 1, 1)
    return (Ts, geom[:B], J8[:B], L[:B], img[1:B + 1], TUM_FR1.at_level(level), IC_ITERATIONS, 0.0, 1.0), dict(
        H=H, W=W, sampling="bilinear")


def _ic_wrapper(kernel):
    from phovo_tpu_torch.ops import ic as IC
    from phovo_tpu_torch.ops import ic_batch as ICB

    return IC.ic_precompute_batch if kernel == "icpre" else ICB.ic_gn_level_batch


def _assert_icpre_close(J8, L, pJ8, pL):
    """K-ICpre's bounds: J8 rows within 1e-6 (the same expressions), the
    factor within 1e-4 of its largest entry (the Gram's sums in another
    order)."""
    torch.testing.assert_close(J8, pJ8, rtol=0, atol=1e-6)
    scale = pL.abs().amax(dim=1, keepdim=True)
    assert bool(((L - pL).abs() <= 1e-4 * scale).all()), float(((L - pL).abs() / scale).max())


@pytest.mark.parametrize("B", [1, 16, 256])
@pytest.mark.parametrize("level", sorted(IC_LEVELS))
@pytest.mark.parametrize("kernel", ["ic", "icpre"])
def test_ic_cluster_kernels_match_plain_at_vga(kernel, level, B):
    """K-IC and K-ICpre in the rule's layout against their plain versions
    at 480x640, 120x160 and 60x80, on 1, 16 and 256 pairs (frames): poses
    within STATE_ATOL, iteration and valid counts equal; K-ICpre within
    its bounds."""
    from phovo_tpu_torch.ops import ic as IC
    from phovo_tpu_torch.ops import ic_batch as ICB

    args, kw = _ic_call(kernel, level, B)
    k = _ic_wrapper(kernel)(*args, **kw)
    if kernel == "icpre":
        _assert_icpre_close(*k, *IC.ic_precompute_batch_reference(*args))
        return
    parts = []
    for lo in range(0, B, 64):
        sl = slice(lo, lo + 64)
        parts.append(ICB.ic_gn_level_batch_reference(*(x[sl] for x in args[:5]), *args[5:], **kw))
        torch.cuda.empty_cache()
    p = type(parts[0])(*(torch.cat(x) for x in zip(*parts)))
    torch.cuda.synchronize()
    torch.testing.assert_close(k.T, p.T, rtol=0, atol=STATE_ATOL)
    assert torch.equal(k.iterations, p.iterations)
    assert torch.equal(k.num_valid, p.num_valid)


def _ic_entry_launch(kernel, args, kw, cluster, resident=None):
    """One launch through the C entry at `cluster` blocks a pair (K-IC
    resident, streamed, or by the rule when None): (the CUDA error, the
    outputs)."""
    from phovo_tpu_torch.ops import _build
    from phovo_tpu_torch.ops import ic as IC
    from phovo_tpu_torch.ops import ic_batch as ICB

    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "icpre":
        values, outs = IC._ic_precompute_launch_args(*args, stream=stream, cluster=cluster)
    else:
        values, (_, *outs) = ICB._ic_launch_args(*args, **kw, stream=stream, cluster=cluster, resident=resident)
    err = getattr(_build.library(), IC_ENTRY[kernel])(*values)
    torch.cuda.synchronize()
    return err, outs


@pytest.mark.parametrize("level", range(5))
@pytest.mark.parametrize("kernel", ["ic", "icpre"])
def test_ic_every_cluster_size_matches_one_block(kernel, level):
    """Every cluster size forced through the C entry (16 where the card
    schedules it; a refusal must be cudaErrorInvalidClusterSize, 912)
    against one block a pair, on 16 pairs (frames): K-IC's poses within
    STATE_ATOL with equal iteration and valid counts; K-ICpre's J8 the
    same bits, its factor within 1e-4 of its largest entry."""
    args, kw = _ic_call(kernel, level, 16)
    err, base = _ic_entry_launch(kernel, args, kw, 1, resident=False)
    assert err == 0
    for c in IC_SIZES[1:]:
        err, outs = _ic_entry_launch(kernel, args, kw, c, resident=False)
        if c == 16 and err == 912:
            continue
        assert err == 0, (c, err)
        if kernel == "icpre":
            J8, L = outs
            assert torch.equal(J8, base[0]), c
            _assert_icpre_close(J8, L, *base)
        else:
            state, diag = outs
            torch.testing.assert_close(state, base[0], rtol=0, atol=STATE_ATOL)
            assert torch.equal(diag[:, 0], base[1][:, 0]) and torch.equal(diag[:, 3], base[1][:, 3]), c


@pytest.mark.parametrize("level", range(1, 5))
def test_ic_resident_pack_gives_the_streamed_bits(level):
    """At every cluster size whose pack fits in shared memory, a resident
    level gives the bits of a streamed one: each thread keeps its pixels
    and their order."""
    from phovo_tpu_torch.ops import ic_batch as ICB

    args, kw = _ic_call("ic", level, 16)
    fits = [c for c in IC_SIZES if ICB.ic_pack_fits(kw["H"], kw["W"], c)]
    assert fits
    for c in fits:
        err_s, streamed = _ic_entry_launch("ic", args, kw, c, resident=False)
        err_r, resident = _ic_entry_launch("ic", args, kw, c, resident=True)
        if c == 16 and 912 in (err_s, err_r):
            continue
        assert (err_s, err_r) == (0, 0), c
        assert all(torch.equal(a, b) for a, b in zip(resident, streamed)), c


@pytest.mark.parametrize("level", sorted(IC_LEVELS))
@pytest.mark.parametrize("kernel", ["ic", "icpre"])
def test_ic_pair_alone_gives_its_bits_in_a_256_pair_launch(kernel, level):
    """A pair (frame) alone gives the bits it has inside a 256-pair
    (257-frame) launch: the layout is the level's, whatever B."""
    B = 256 if kernel == "ic" else 257
    args, kw = _ic_call(kernel, level, B)
    batch = _ic_wrapper(kernel)(*args, **kw)
    n = 5 if kernel == "ic" else 4
    for j in (0, 1, 128, 255):
        one = _ic_wrapper(kernel)(*(x[j:j + 1] for x in args[:n]), *args[n:], **kw)
        for x, y in zip(one, batch):
            assert torch.equal(x, y[j:j + 1]), j


@pytest.mark.parametrize("kernel", ["ic", "icpre"])
def test_ic_unschedulable_cluster_raises(kernel, monkeypatch):
    """A cluster the card cannot schedule (32 blocks, above Hopper's 16)
    raises through the wrapper and counts no launch; there is no retry
    with smaller clusters, and the next launch is unaffected."""
    from phovo_tpu_torch.ops import ic as IC
    from phovo_tpu_torch.ops import ic_batch as ICB

    args, kw = _ic_call(kernel, 2, 4)
    ok = _ic_wrapper(kernel)(*args, **kw)
    before = (IC.IC_PRE_LAUNCHES, ICB.IC_LAUNCHES)
    module, rule = (IC, "ic_precompute_cluster_size") if kernel == "icpre" else (ICB, "ic_cluster_size")
    monkeypatch.setattr(module, rule, lambda H, W: 32)
    with pytest.raises(RuntimeError, match="launch failed: CUDA error"):
        _ic_wrapper(kernel)(*args, **kw)
    assert (IC.IC_PRE_LAUNCHES, ICB.IC_LAUNCHES) == before
    monkeypatch.undo()
    again = _ic_wrapper(kernel)(*args, **kw)
    for x, y in zip(ok, again):
        assert torch.equal(x, y)


def test_ic_resident_pack_too_large_raises(monkeypatch):
    """A resident pack above the shared memory a block may use (480x640
    at one block a pair: 13.5 MB) is refused, not run streamed: the
    wrapper raises and counts no launch."""
    from phovo_tpu_torch.ops import ic_batch as ICB

    args, kw = _ic_call("ic", 0, 2)
    before = ICB.IC_LAUNCHES
    monkeypatch.setattr(ICB, "ic_cluster_size", lambda H, W: 1)
    monkeypatch.setattr(ICB, "ic_resident", lambda H, W, cluster: True)
    with pytest.raises(RuntimeError, match="launch failed: CUDA error"):
        ICB.ic_gn_level_batch(*args, **kw)
    assert ICB.IC_LAUNCHES == before


# -- the one-linearization kernel split over lin_split(H, W) blocks a pair ----

LIN_SPLITS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def _lin_call(level, B, sampling="bilinear", loss="none"):
    """(args, kw) of fused_lin_batch for the first B pairs (frame k to k +
    1) of _vga_packs' frames at a VGA level, at small seeded states."""
    from phovo_tpu_torch.ops.camera import TUM_FR1

    i0, geom, t_all = _vga_packs(False)[level]
    H, W = VGA_LEVELS[level]
    states = torch.from_numpy((np.random.default_rng(level).standard_normal((B, 6)) * 1e-3).astype(np.float32))
    args = (i0[:B].contiguous(), geom[:B].contiguous(), t_all[1:B + 1].contiguous(), TUM_FR1.at_level(level),
            states.cuda())
    return args, dict(H=H, W=W, sampling=sampling, robust_loss=loss, robust_delta=DELTAS[loss])


def _assert_gram_close(k, p):
    """K-LIN's bounds: the Gram within 1e-4 of each pair's largest entry
    (the pixel sums in another order), valid counts equal, the band slot
    0, symmetric."""
    scale = p.abs().amax(dim=(1, 2), keepdim=True)
    assert bool(((k - p).abs() <= 1e-4 * scale).all()), float(((k - p).abs() / scale).max())
    assert torch.equal(k[:, 7, 7], p[:, 7, 7])
    assert float(k[:, 6, 7].abs().sum()) == 0.0
    assert torch.equal(k, k.transpose(1, 2))


def _lin_entry(args, kw, split, partials=None):
    """One K-LIN launch through the C entry at a forced layout: (the CUDA
    error, the Grams)."""
    from phovo_tpu_torch.ops import _build

    values, (gram, *_) = FB._lin_launch_args(*args, **kw, stream=torch.cuda.current_stream().cuda_stream,
                                             split=split, partials=partials)
    err = _build.library().phovo_fused_lin(*values)
    torch.cuda.synchronize()
    return err, gram


@pytest.mark.parametrize("loss", ["none", "huber", "tdist"])
@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("level", sorted(VGA_LEVELS))
def test_lin_kernel_matches_plain_at_vga(level, B, sampling, loss):
    """K-LIN at 480x640 and 120x160 at the rule's split (lin_split: 128 and
    8 blocks a pair) against its plain version, one launch counted."""
    args, kw = _lin_call(level, B, sampling, loss)
    before = FB.LIN_LAUNCHES
    k = FB.fused_lin_batch(*args, **kw)
    assert FB.LIN_LAUNCHES == before + 1
    p = FB.fused_lin_batch_reference(*args, **kw)
    torch.cuda.synchronize()
    _assert_gram_close(k, p)


@pytest.mark.parametrize("level", sorted(VGA_LEVELS))
def test_lin_pair_alone_gives_its_row_of_a_batch(level):
    """A pair alone gives the bits of its row in a 256-pair launch: the
    split is the level's, whatever B."""
    args, kw = _lin_call(level, 256)
    batch = FB.fused_lin_batch(*args, **kw)
    for j in (0, 1, 128, 255):
        one = FB.fused_lin_batch(*(x[j:j + 1] for x in args[:3]), args[3], args[4][j:j + 1], **kw)
        assert torch.equal(one[0], batch[j]), j


@pytest.mark.parametrize("level", sorted(VGA_LEVELS))
def test_lin_every_layout_matches_one_block(level):
    """Every split G forced through the C entry against G = 1 on 16 pairs
    within the Gram's bounds; G = 1 forced is the wrapper's one-block
    layout, bit for bit."""
    args, kw = _lin_call(level, 16)
    err, base = _lin_entry(args, kw, 1)
    assert err == 0
    H, W = VGA_LEVELS[level]
    with mock.patch.object(FB, "lin_split", lambda H, W: 1):
        assert torch.equal(FB.fused_lin_batch(*args, **kw), base)
    for split in LIN_SPLITS[1:]:
        err, gram = _lin_entry(args, kw, split)
        assert err == 0, (split, err)
        _assert_gram_close(gram, base)


def test_lin_refuses_a_small_scratch_and_a_split_below_one(monkeypatch):
    """A scratch smaller than B * G * 35 floats and a split of 0 are
    refused before anything runs (cudaErrorInvalidValue, 1); the wrapper
    raises and counts no launch, and the next launch is unaffected."""
    args, kw = _lin_call(2, 4)
    ok = FB.fused_lin_batch(*args, **kw)
    G = FB.lin_split(*VGA_LEVELS[2])
    err, _ = _lin_entry(args, kw, G, partials=torch.empty(4 * G * 35 - 1, device="cuda"))
    assert err == 1
    err, _ = _lin_entry(args, kw, 0)
    assert err == 1
    before = FB.LIN_LAUNCHES
    monkeypatch.setattr(FB, "lin_split", lambda H, W: 0)
    with pytest.raises(RuntimeError, match="launch failed: CUDA error"):
        FB.fused_lin_batch(*args, **kw)
    assert FB.LIN_LAUNCHES == before
    monkeypatch.undo()
    assert torch.equal(FB.fused_lin_batch(*args, **kw), ok)


def _room_tracker(device, n_kf=6, shape=(120, 160), noise=0.01, seed=3):
    """A keyframe tracker on `device` holding n_kf hand-inserted room
    keyframes at noisy poses (tests/test_photometric_ba.py's _room_kvo with
    the port's renderer), and the true world<-keyframe poses."""
    from phovo_tpu_torch.models.analytic import PhotoconsistencyOdometryAnalytic
    from phovo_tpu_torch.models.keyframe import Keyframe, KeyframeVisualOdometry
    from phovo_tpu_torch.ops import se3
    from phovo_tpu_torch.utils.config import PhovoConfig
    from phovo_tpu_torch.utils.synthetic import render_room

    H, W = shape
    fx = 525.0 * W / 640.0
    intr = Intrinsics(fx, fx, (W - 1) / 2, (H - 1) / 2)
    cfg = PhovoConfig(num_levels=1, blur_filter_sizes=(0,), gradient_scales=(0.0625,), max_iterations=(1,),
                      lambda_steps=(1.0,), min_gradient_norms=(0.0,))
    vo = PhotoconsistencyOdometryAnalytic(cfg, device=device)
    vo.set_intrinsic_matrix([[fx, 0, intr.cx], [0, fx, intr.cy], [0, 0, 1]])
    kvo = KeyframeVisualOdometry(vo)
    rng = np.random.default_rng(seed)
    gt = np.zeros((n_kf, 6))
    gt[:, 0] = np.linspace(0.0, 0.5, n_kf)
    gt[:, 3] = np.linspace(0.0, 0.2, n_kf)
    for m in range(n_kf):
        I, D = render_room(intr, shape, se3.pose_matrix_np(gt[m]))
        noisy = gt[m] + (np.concatenate([rng.normal(0, noise, 3), rng.normal(0, noise / 2, 3)]) if m else 0.0)
        kvo.keyframes.append(Keyframe(index=m, frame_index=m, timestamp=float(m), intensity=I, depth=D,
                                      pose=np.linalg.inv(se3.pose_matrix_np(noisy)), device=device))
    return kvo, [np.linalg.inv(se3.pose_matrix_np(g)) for g in gt]


@pytest.mark.parametrize("scope", ["window", "global", "sequential"])
@pytest.mark.parametrize("damping", [1.0, 1e-3])
def test_backend_on_the_card_matches_the_cpu_and_repeats_its_bits(scope, damping):
    """The photometric bundle adjustment of finalize on the card, 3
    iterations: two runs give the same bits (the blocks are summed in a
    fixed order), and the CPU's run from the same keyframes agrees. At
    damping 1.0 within 5e-5 (chip_smoke.BA_CPU_ATOL: the refinement's own
    answer to float32 noise in its start, up to 1.2e-5 on the CPU). At
    1e-3 by outcome: both cut the mean keyframe position error below
    0.75x (0.33-0.49x measured on an H100 and its host's CPU). Not at the
    production 1e-4: there one LM step amplifies float32 differences about
    1e4-fold, and on these six keyframes the outcome swings with it.
    'sequential' is the windowed loop again with the dense budget at 0, so
    that every window takes the sparse Schur path."""
    card, gt = _room_tracker("cuda")
    cpu, _ = _room_tracker("cpu")
    start = [k.pose.copy() for k in card.keyframes]

    def refine(kvo):
        for k, p in zip(kvo.keyframes, start):
            k.pose = p.copy()
        if scope == "sequential":
            from phovo_tpu_torch.parallel import bundle_adjustment as TB

            with mock.patch.object(TB, "DENSE_W_BUDGET_BYTES", 0):
                kvo._refine_photometric(None, 3, 4, 6, damping, 0.1, 0.3, 0.02)
        else:
            kvo.finalize(ba_iterations=3, ba_window=4, ba_grid=6, ba_scope=scope, ba_covis=3, ba_damping=damping)
        return [k.pose.copy() for k in kvo.keyframes], kvo.map_points.copy()

    first, again, on_cpu = refine(card), refine(card), refine(cpu)
    assert all(np.array_equal(a, b) for a, b in zip(first[0], again[0])) and np.array_equal(first[1], again[1])
    assert len(first[1]) == len(on_cpu[1]) > 0

    def err(poses):
        return float(np.mean([np.linalg.norm(p[:3, 3] - g[:3, 3]) for p, g in zip(poses, gt)]))

    if damping == 1.0:
        assert max(float(np.abs(a - b).max()) for a, b in zip(first[0], on_cpu[0])) <= 5e-5
        assert max(float(np.abs(a - b).max()) for a, b in zip(first[0], start)) > 5e-4
    else:
        errs = (err(start), err(first[0]), err(on_cpu[0]))
        assert errs[1] < 0.75 * errs[0] and errs[2] < 0.75 * errs[0], errs


# -- the mesh forms on the card ---------------------------------------------------


def _mesh_inputs():
    """9 frames at 96x128 (uint8, metres) for the card's mesh cases."""
    I, D, _, _ = make_sequence(INTR, (96, 128), 9)
    return np.round(np.stack(I) * 255.0).astype(np.uint8), np.stack(D).astype(np.float32)


def rank_mesh_forms(I8, D, pixel_parallel):
    """The mesh forms of the card's cases on every rank of the world, on
    cuda:0 (spawned ranks import this module to run it): the data-parallel
    aligner at B = 8 and 7 (K-GN), the chunked server on 4 streams of 3
    frames, on a mesh of data = the world; the pixel-sharded aligner on a
    mesh of pixel = pixel_parallel. {form: (result, K-GN launches)}."""
    import torch.distributed as dist

    from phovo_tpu_torch.parallel import batch
    from phovo_tpu_torch.parallel.distributed import to_numpy
    from phovo_tpu_torch.parallel.mesh import make_mesh
    from phovo_tpu_torch.parallel.sharded_ne import make_pixel_sharded_aligner
    from phovo_tpu_torch.utils.config import PhovoConfig

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    n = dist.get_world_size() if dist.is_initialized() else 1
    cfg = PhovoConfig(num_levels=3, blur_filter_sizes=(0,) * 3, gradient_scales=(0.0625,) * 3,
                      max_iterations=(3, 3, 4), lambda_steps=(1.0,) * 3, min_gradient_norms=(0.0,) * 3,
                      sampling="bilinear")
    I, Dm = torch.from_numpy(I8).to(dev), torch.from_numpy(D).to(dev)
    out = {}

    def run(name, fn):
        FB.LAUNCHES = 0
        res = fn()
        torch.cuda.synchronize()
        out[name] = (to_numpy(res), FB.LAUNCHES)

    data = make_mesh(n, devices=[dev] * n)
    align = batch.make_data_parallel_aligner(data, cfg, use_fused=True)
    for B in (8, 7):
        run(f"dp {B}", lambda: align(I[:B], Dm[:B], I[1:B + 1], Dm[1:B + 1], INTR, torch.zeros((B, 6), device=dev)))
    serve = batch.make_chunked_sequence_server(data, cfg)
    idx = torch.arange(12, device=dev).reshape(4, 3) % 9
    run("chunked", lambda: serve(I[idx[:, 0]], Dm[idx[:, 0]], I[idx[:, 1:]], Dm[idx[:, 1:]], INTR))
    pixel = make_mesh(n, pixel_parallel=pixel_parallel, devices=[dev] * n)
    run("pixel", lambda: make_pixel_sharded_aligner(pixel, cfg)(I[0], Dm[0], I[1], Dm[1], INTR,
                                                                torch.zeros(6, device=dev)))
    return out


@pytest.fixture(scope="module")
def card_mesh_runs(tmp_path_factory):
    """The card's mesh cases: unsharded (no process group), one rank in an
    NCCL group (this process), and two gloo ranks sharing the card."""
    import torch.distributed as dist

    from phovo_tpu_torch.ops import _build
    from phovo_tpu_torch.parallel import distributed

    _build.library()  # built once, before any rank starts
    I8, D = _mesh_inputs()
    ref = rank_mesh_forms(I8, D, 1)
    tmp = tmp_path_factory.mktemp("mesh")
    assert distributed.initialize(f"file://{tmp / 'nccl'}", 1, 0, backend="nccl")
    try:
        nccl = rank_mesh_forms(I8, D, 1)
    finally:
        dist.destroy_process_group()
    gloo = distributed.spawn_ranks(rank_mesh_forms, 2, f"file://{tmp / 'gloo'}", args=(I8, D, 2), backend="gloo")
    return ref, nccl, gloo


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [a for y in x for a in _leaves(y)]
    return [np.asarray(x)]


def _bits(a, b):
    return all(np.array_equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


@pytest.mark.parametrize("form", ["dp 8", "dp 7", "chunked"])
def test_mesh_data_axis_gives_the_unsharded_bits_on_the_card(card_mesh_runs, form):
    """A pair's result on the card does not depend on its batch: one rank
    in an NCCL group and two gloo ranks (data = 2, the odd B padded) give
    the unsharded call's bits, each rank launching K-GN."""
    ref, nccl, gloo = card_mesh_runs
    assert _bits(nccl[form][0], ref[form][0]) and nccl[form][1] == ref[form][1] > 0
    for rank in gloo:
        assert _bits(rank[form][0], ref[form][0]) and rank[form][1] > 0


def test_mesh_pixel_aligner_on_the_card(card_mesh_runs):
    """The pixel-sharded aligner over two gloo ranks (pixel = 2) within
    1e-5 of the unsharded one, both ranks the same bits; one NCCL rank
    gives the unsharded bits."""
    ref, nccl, gloo = card_mesh_runs
    assert _bits(nccl["pixel"][0], ref["pixel"][0])
    assert _bits(gloo[0]["pixel"][0], gloo[1]["pixel"][0])
    got, want = gloo[0]["pixel"][0], ref["pixel"][0]
    np.testing.assert_allclose(got.state, want.state, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.iterations, want.iterations)


# -- the iteration trace through K-LIN --------------------------------------------


@pytest.mark.parametrize("case", [{}, {"gradient_at": "esm"}, {"robust_loss": "tdist", "robust_delta": 0.1},
                                  {"sampling": "nearest", "max_iterations": (2, 2)}],
                         ids=["warped", "esm", "tdist", "nearest"])
def test_trace_alignment_through_klin_matches_plain(case):
    """utils/trace.trace_alignment on the card launches K-LIN once a
    record (and once a Student-t burn-in step), and replays the plain
    version's records: the same levels and iterations, states within
    2e-4, valid counts equal."""
    from phovo_tpu_torch.ops import fused as fused_ops
    from phovo_tpu_torch.ops.robust import TDIST_BURNIN
    from phovo_tpu_torch.utils.config import PhovoConfig
    from phovo_tpu_torch.utils.trace import trace_alignment

    I, D, _, _ = make_sequence(INTR, (96, 128), 2)
    cfg = PhovoConfig(**{**dict(num_levels=2, blur_filter_sizes=(0, 0), gradient_scales=(0.0625,) * 2,
                                max_iterations=(3, 5), lambda_steps=(1.0,) * 2, min_gradient_norms=(0.0,) * 2,
                                sampling="bilinear"), **case})
    dev = torch.device("cuda")
    before = FB.LIN_LAUNCHES
    kern = trace_alignment(I[0], D[0], I[1], D[1], INTR, cfg, device=dev)
    launches = FB.LIN_LAUNCHES - before
    with mock.patch.object(fused_ops, "fused_lin_batch", FB.fused_lin_batch_reference):
        plain = trace_alignment(I[0], D[0], I[1], D[1], INTR, cfg, device=dev)
    assert FB.LIN_LAUNCHES - before == launches
    assert launches == len(kern) + (TDIST_BURNIN if cfg.robust_loss == "tdist" else 0)
    assert [(r.level, r.iteration) for r in kern] == [(r.level, r.iteration) for r in plain]
    for a, b in zip(kern, plain):
        np.testing.assert_allclose(a.state, b.state, rtol=0, atol=2e-4)
        assert a.num_valid == b.num_valid


# -- K-PREP (csrc/prep_levels.cu) against the torch chain ------------------------

VGA = (480, 640)
COUNTS_TO_M = 1.0 / 5000.0


def _prep_config(name, **changes):
    """A shipped preset, with its prep's gradient_at (the ceres backend
    packs the four-row warped geometry)."""
    import dataclasses

    from phovo_tpu_torch.utils.config import load_builtin

    cfg = load_builtin(name)
    return dataclasses.replace(cfg, **({"gradient_at": "warped"} | changes))


@functools.cache
def _storage_frames(n, seed=0):
    """n VGA frames in storage dtype on the card: uint8 intensity and
    uint16 depth counts at 5000 a metre, a tenth of them holes (0) and a
    sixth beyond the 5 m limit."""
    rng = np.random.default_rng(seed)
    i8 = rng.integers(0, 256, (n, *VGA), dtype=np.uint8)
    d16 = rng.integers(1, 30_000, (n, *VGA), dtype=np.uint16)
    d16[rng.random((n, *VGA)) < 0.1] = 0
    return torch.from_numpy(i8).cuda(), torch.from_numpy(d16).cuda()


def _assert_packs_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for level in got:
        for g, w in zip(got[level], want[level]):
            assert (g is None) == (w is None), level
            if g is not None:
                assert g.shape == w.shape and g.dtype == w.dtype, level
                assert torch.equal(g, w), f"level {level}: {int((g != w).sum())} values differ"


def test_k_prep_live_pair_is_one_launch_with_the_torch_chains_bits():
    """The object API's ceres pair (uint8 intensity, float32 metres): ONE
    K-PREP launch gives the source's (i0, geom) and the target's t_all at
    all five levels, equal to the torch chain's."""
    from phovo_tpu_torch.ops import prep

    i8, d16 = _storage_frames(2)
    sd = d16[0].to(torch.float32) * COUNTS_TO_M
    cfg = _prep_config("config_5_level_optimization_ceres")
    before = (prep.PREP_LAUNCHES, prep.PREP_TORCH_CALLS)
    got = prep.prep_pair(i8[0], sd, i8[1], TUM_FR1, cfg)
    assert (prep.PREP_LAUNCHES, prep.PREP_TORCH_CALLS) == (before[0] + 1, before[1])
    torch.cuda.synchronize()
    src = prep.prep_levels_torch(prep.device_unit_intensity(i8[0]), sd, TUM_FR1, cfg, targets=False)
    tgt = prep.prep_levels_torch(prep.device_unit_intensity(i8[1]), None, TUM_FR1, cfg)
    want = {level: (i0[None], geom[None], tgt[level][2][None]) for level, (i0, geom, _) in src.items()}
    assert sorted(got) == [0, 1, 2, 3, 4]
    _assert_packs_equal(got, want)


@pytest.mark.parametrize("preset,depth", [
    ("config_5_level_optimization_ceres", "counts"),
    ("config_5_level_optimization_analytic", "counts"),
    ("config_5_level_optimization_ceres", "metres"),
])
def test_k_prep_chunk_matches_the_torch_chain(preset, depth):
    """A 257-frame chunk, the float32 carry then 256 new frames (uint8;
    uint16 counts or float32 metres): ONE launch gives the 256 pairs'
    packs at every active level and the new carry, equal to
    chunk_device_prep and the torch chain's."""
    from phovo_tpu_torch.ops import prep

    i8, d16 = _storage_frames(257)
    ci = prep.device_unit_intensity(i8[0])
    cd = d16[0].to(torch.float32) * float(np.float32(COUNTS_TO_M))
    frames = d16[1:] if depth == "counts" else d16[1:].to(torch.float32) * float(np.float32(COUNTS_TO_M))
    cfg = _prep_config(preset)
    before = prep.PREP_LAUNCHES
    got, gci, gcd = prep.prep_chunk(ci, cd, i8[1:], frames, COUNTS_TO_M, TUM_FR1, cfg)
    assert prep.PREP_LAUNCHES == before + 1
    torch.cuda.synchronize()
    I, D = prep.chunk_device_prep(ci, cd, i8[1:], frames, COUNTS_TO_M)
    full = prep.prep_levels_torch(I, D, TUM_FR1, cfg)
    want = {level: (i0[:-1], geom[:-1], t_all[1:]) for level, (i0, geom, t_all) in full.items()}
    assert sorted(got) == [lv for lv, n in enumerate(cfg.max_iterations) if n > 0]
    _assert_packs_equal(got, want)
    assert torch.equal(gci, I[-1]) and torch.equal(gcd, D[-1])


def test_k_prep_esm_rows_match_the_torch_chain():
    """gradient_at='esm': the six-row geometry (the frame's own gradients
    as rows 4 and 5) of float32 frames, equal to the torch chain's."""
    from phovo_tpu_torch.ops import prep

    i8, d16 = _storage_frames(9)
    I = prep.device_unit_intensity(i8)
    D = d16.to(torch.float32) * float(np.float32(COUNTS_TO_M))
    cfg = _prep_config("config_5_level_optimization_analytic", gradient_at="esm")
    before = prep.PREP_LAUNCHES
    got = prep.prep_frames(I, D, TUM_FR1, cfg)
    assert prep.PREP_LAUNCHES == before + 1
    torch.cuda.synchronize()
    assert all(geom.shape[1] == 6 for _, geom, _ in got.values())
    _assert_packs_equal(got, prep.prep_levels_torch(I, D, TUM_FR1, cfg))


def test_k_prep_targets_only_match_the_torch_chain():
    """Tracked frames as targets only, from uint8: ONE launch, the torch
    chain's t_all at every active level."""
    from phovo_tpu_torch.ops import prep

    i8, _ = _storage_frames(17)
    cfg = _prep_config("config_5_level_optimization_ceres")
    before = prep.PREP_LAUNCHES
    got = prep.prep_targets(i8[1:], cfg)
    assert prep.PREP_LAUNCHES == before + 1
    torch.cuda.synchronize()
    want = prep.prep_levels_torch(prep.device_unit_intensity(i8[1:]), None, None, cfg)
    _assert_packs_equal({lv: (t,) for lv, t in got.items()}, {lv: (t,) for lv, (_, _, t) in want.items()})


def test_k_prep_leaves_a_blurred_preset_to_the_torch_chain():
    """A preset that blurs an active level runs the torch chain on the
    card, counted as such, and launches no K-PREP."""
    from phovo_tpu_torch.ops import prep

    i8, d16 = _storage_frames(2)
    cfg = _prep_config("config_3_level_optimization_ceres")
    assert not prep.kernel_takes(cfg, VGA)
    before = (prep.PREP_LAUNCHES, prep.PREP_TORCH_CALLS)
    prep.prep_pair(i8[0], d16[0].to(torch.float32) * COUNTS_TO_M, i8[1], TUM_FR1, cfg)
    torch.cuda.synchronize()
    assert (prep.PREP_LAUNCHES, prep.PREP_TORCH_CALLS) == (before[0], before[1] + 1)
