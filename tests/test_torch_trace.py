"""The per-iteration trace (utils/trace.py, the reference's
visualizeIterations) against phovo_tpu's trace_alignment, on the CPU:
tests/test_trace.py's cases, each held to phovo_tpu's replay on the same
frames. Records, levels and iterations equal; states within 1e-5; costs
within 1e-4 relative (two float32 states 3e-8 apart give costs up to
1.3e-4 apart near convergence), gradient norms within 1e-3; valid counts
equal.

The pair is 60x80 with a depth-less border of 4 pixels in both frames:
from zero a border pixel warps onto the bilinear edge u = 0, where the two
packages round to opposite sides, and the bi-objective depth residual
jumps at a target depth edge. 'warped' and 'esm' linearize through
make_fused_linearizer (the one-linearization kernel's plain version
here), 'source' and the bi-objective backend through the exact path.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phovo_tpu.ops.camera import Intrinsics as JIntrinsics
from phovo_tpu.utils import trace as jtrace
from phovo_tpu.utils.config import PhovoConfig as JConfig
from phovo_tpu_torch.models.analytic import align_analytic
from phovo_tpu_torch.ops import fused as fused_ops
from phovo_tpu_torch.ops import fused_batch as FB
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.utils import trace
from phovo_tpu_torch.utils.config import PhovoConfig
from phovo_tpu_torch.utils.synthetic import make_pair
from phovo_tpu_torch.utils.viz import alignment_diff

torch.set_num_threads(1)

# tests/test_trace.py's CFG
CFG = dict(num_levels=2, blur_filter_sizes=(0, 0), gradient_scales=(0.0625,) * 2, max_iterations=(3, 5),
           lambda_steps=(1.0,) * 2, min_gradient_norms=(0.0,) * 2, sampling="bilinear")
INTR = Intrinsics(80.0, 80.0, 39.5, 29.5)
JINTR = JIntrinsics(*(np.float32(v) for v in INTR))
STATE_ATOL = 1e-5
COST_RTOL = 1e-4
# ||J^T r|| cancels as the state converges (chip_smoke.py holds the
# kernels' to the same 1e-3)
GNORM_RTOL = 1e-3


@pytest.fixture(scope="module")
def pair():
    I0, D0, I1, D1, gt = make_pair(INTR, (60, 80))
    for D in (D0, D1):
        D[:4], D[-4:], D[:, :4], D[:, -4:] = 0.0, 0.0, 0.0, 0.0
    return I0, D0, I1, D1, gt


def _both(pair, backend="analytic", **overrides):
    I0, D0, I1, D1, _ = pair
    cfg = dict(CFG, **overrides)
    ref = jtrace.trace_alignment(I0, D0, I1, D1, JINTR, JConfig(**cfg), backend=backend)
    got = trace.trace_alignment(I0, D0, I1, D1, INTR, PhovoConfig(**cfg), backend=backend, device="cpu")
    assert [(r.level, r.iteration) for r in got] == [(r.level, r.iteration) for r in ref]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.state, b.state, rtol=0, atol=STATE_ATOL)
        np.testing.assert_allclose(a.cost, b.cost, rtol=COST_RTOL)
        np.testing.assert_allclose(a.gradient_norm, b.gradient_norm, rtol=GNORM_RTOL)
        assert a.num_valid == b.num_valid > 0
        assert isinstance(a.state, np.ndarray) and a.state.shape == (6,)
    return got


@pytest.mark.parametrize("case", [{}, {"gradient_at": "esm"}, {"gradient_at": "source"},
                                  {"robust_loss": "tdist", "robust_delta": 0.1},
                                  {"sampling": "nearest", "max_iterations": (2, 2)}],
                         ids=["warped", "esm", "source", "tdist", "nearest"])
def test_trace_matches_jax_and_the_solver(pair, case):
    """Every record held to phovo_tpu's; the last state is the per-pair
    solver's (align_analytic, exact path)."""
    before = FB.LIN_LAUNCHES
    records = _both(pair, **case)
    assert len(records) == sum(dict(CFG, **case)["max_iterations"])  # full budgets at min_gradient_norm 0
    assert [r.level for r in records][0] == 1 and records[-1].level == 0
    I0, D0, I1, D1 = map(torch.from_numpy, pair[:4])
    res = align_analytic(I0, D0, I1, D1, INTR, torch.zeros(6), PhovoConfig(**dict(CFG, **case)), use_fused=False)
    np.testing.assert_allclose(records[-1].state, res.state.numpy(), rtol=0, atol=STATE_ATOL)
    assert FB.LIN_LAUNCHES == before  # CPU tensors launch nothing


def test_trace_linearizes_through_make_fused_linearizer(pair, monkeypatch):
    """'warped' and 'esm' take one make_fused_linearizer a level (packs
    built once) and one call an iteration, t-dist's burn-in included;
    'source' takes none."""
    made, calls = [], []
    real = fused_ops.make_fused_linearizer

    def counting(*args, **kw):
        lin = real(*args, **kw)
        made.append(args)

        def linearize(s, robust_scale=None):
            calls.append(robust_scale)
            return lin(s, robust_scale=robust_scale)

        return linearize

    monkeypatch.setattr(fused_ops, "make_fused_linearizer", counting)
    I0, D0, I1, D1, _ = pair
    for case, n_made, n_calls in (({}, 2, 8), ({"gradient_at": "esm"}, 2, 8),
                                  ({"robust_loss": "tdist", "robust_delta": 0.1}, 2, 8 + 4),
                                  ({"gradient_at": "source"}, 0, 0)):
        made.clear()
        calls.clear()
        records = trace.trace_alignment(I0, D0, I1, D1, INTR, PhovoConfig(**dict(CFG, **case)), device="cpu")
        assert (len(made), len(calls), len(records)) == (n_made, n_calls, 8), case
        assert [c is not None for c in calls] == ["robust_loss" in case] * n_calls


def test_trace_termination_criterion(pair):
    """A large min_gradient_norm stops each level after one iteration."""
    records = _both(pair, min_gradient_norms=(1e12, 1e12))
    assert [(r.level, r.iteration) for r in records] == [(1, 1), (0, 1)]


def test_trace_biobjective_matches_jax(pair):
    records = _both(pair, backend="biobjective", max_iterations=(2, 2))
    assert len(records) == 4 and all(np.isfinite(r.state).all() for r in records)


def test_trace_rejects_unsupported_backend(pair):
    I0, D0, I1, D1, _ = pair
    for backend in ("ceres", "ic"):
        with pytest.raises(ValueError, match="trust-region"):
            trace.trace_alignment(I0, D0, I1, D1, INTR, PhovoConfig(**CFG), backend=backend, device="cpu")


def test_trace_takes_uint8_frames_and_init_state(pair):
    """u8 frames are scaled by 1/255 on the device, as the float frames
    they came from; init_state starts the replay elsewhere."""
    I0, D0, I1, D1, _ = pair
    u0, u1 = (np.round(I * 255).astype(np.uint8) for I in (I0, I1))
    cfg = PhovoConfig(**dict(CFG, max_iterations=(1, 2)))
    a = trace.trace_alignment(u0, D0, u1, D1, INTR, cfg, device="cpu")
    b = trace.trace_alignment(u0.astype(np.float32) * np.float32(1 / 255), D0, u1.astype(np.float32) * np.float32(1 / 255),
                              D1, INTR, cfg, device="cpu")
    assert all(np.array_equal(x.state, y.state) for x, y in zip(a, b))
    init = np.array([0.01, 0, 0, 0, 0, 0], np.float32)
    c = trace.trace_alignment(I0, D0, I1, D1, INTR, cfg, init_state=init, device="cpu")
    ref = jtrace.trace_alignment(I0, D0, I1, D1, JINTR, JConfig(**dict(CFG, max_iterations=(1, 2))),
                                 init_state=init)
    np.testing.assert_allclose(c[-1].state, ref[-1].state, rtol=0, atol=STATE_ATOL)


def test_save_iteration_diffs_writes_phovo_tpus_images(pair, tmp_path):
    """One PNG a record, named as phovo_tpu's; each decodes to the port's
    alignment_diff at the record's state and agrees with phovo_tpu's image
    (its states within 1e-5: a pixel whose truncated target flips may
    differ)."""
    I0, D0, I1, D1, _ = pair
    cfg = dict(CFG, max_iterations=(1, 2))
    recs = trace.trace_alignment(I0, D0, I1, D1, INTR, PhovoConfig(**cfg), device="cpu")
    jrecs = jtrace.trace_alignment(I0, D0, I1, D1, JINTR, JConfig(**cfg))
    paths = trace.save_iteration_diffs(recs, I0, D0, I1, INTR, tmp_path / "port", device="cpu")
    jpaths = jtrace.save_iteration_diffs(jrecs, I0, D0, I1, JINTR, tmp_path / "jax")
    assert [p.split("/")[-1] for p in paths] == [p.split("/")[-1] for p in jpaths] == [
        "level1_iter001.png", "level1_iter002.png", "level0_iter001.png"]
    for p, jp, rec in zip(paths, jpaths, recs):
        img, ref = cv2.imread(p, cv2.IMREAD_UNCHANGED), cv2.imread(jp, cv2.IMREAD_UNCHANGED)
        assert img.dtype == np.uint8 and img.shape == I0.shape
        expect = np.clip(alignment_diff(I0, D0, I1, rec.state, INTR, device="cpu") * 255.0, 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(img, expect)
        assert (img == ref).mean() > 0.99
