"""The photometric bundle adjustment (phovo_tpu_torch/parallel/
photometric_ba.py) and the keyframe back-end's refinement
(KeyframeVisualOdometry.finalize(ba_iterations > 0)) against phovo_tpu's on
the CPU, on the same numpy keyframes: tests/test_photometric_ba.py's
plane windows at 96x128 and its hand-inserted room keyframes at 64x96
(_room_kvo), so no tracking difference enters.

Held, each tolerance beside the reading that set it:
  * landmark selection and the host builders' arrays equal, bit for bit
    (the same numpy code); the device window builder within 1e-5 relative
    (1.0e-6 measured: the depth weight's mean over the window's depths
    sums in another order);
  * residuals and Jacobians within 1e-4 of each array's largest entry
    (2.1e-5 measured: the projections' cos and sin round apart by an ulp,
    and a bilinear weight carries that into the Jacobian) and the
    {U, V, W, v, w, cost} blocks within 1e-4 of each block's largest entry
    (2.3e-5 measured, in W);
  * one Schur step at damping 1.0 from phovo_tpu's blocks, dense and
    sparse, within 1e-6 (2e-7 measured), and whole runs, the windowed
    loop and every refinement path of finalize at damping 1.0 within 1e-5
    of phovo_tpu's states (7.7e-7 measured; phovo_tpu's finalize pads its
    keyframes and windows, the port's does not, so this also holds the
    unpadded run to the padded one);
  * at the production damping 1e-4 one LM step amplifies last-ulp
    differences about 1e4-fold (ARCHITECTURE.md), so there the port is
    held by outcome, as phovo_tpu's own tests hold its paths: pose error
    contracted (on the plane window; on the room keyframes in the median
    over starts 2e-7 apart, since single starts there are heavy-tailed),
    and the room scene's
    "BA must earn its keep" bounds (BA(3) below 0.6x of the pose-graph
    ATE forward, 0.85x on the loop; 0.52x and 0.69x measured).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phovo_tpu.parallel.photometric_ba as JP
from phovo_tpu.ops import se3 as jse3
from phovo_tpu.ops.camera import Intrinsics as JIntrinsics
from phovo_tpu.parallel import bundle_adjustment as JB
from phovo_tpu.utils.synthetic import render_plane
from phovo_tpu_torch.datasets.tum import RGBDFrame
from phovo_tpu_torch.models import keyframe as tkf
from phovo_tpu_torch.models.analytic import PhotoconsistencyOdometryAnalytic
from phovo_tpu_torch.ops import se3
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.parallel import bundle_adjustment as TB
from phovo_tpu_torch.parallel import photometric_ba as TP
from phovo_tpu_torch.parallel.mesh import make_mesh
from phovo_tpu_torch.utils import synthetic
from phovo_tpu_torch.utils.config import PhovoConfig
from phovo_tpu_torch.utils.trajectory import horn_align
from tests.test_photometric_ba import _room_kvo

torch.set_num_threads(1)

J_INTR = JIntrinsics(np.float32(96.0), np.float32(96.0), np.float32(63.5), np.float32(47.5))
INTR = Intrinsics(96.0, 96.0, 63.5, 47.5)
SHAPE = (96, 128)
LIN_RTOL = 1e-4
BLOCK_RTOL = 1e-4
STEP_ATOL = 1e-6
DAMPED_ATOL = 1e-5
# the room keyframes' windowed refinement (_room_kvo: 7 keyframes at
# 64x96, windows of 4, 36 landmarks a keyframe)
WINDOW, GRID = 4, 6
ONE_KF_CFG = dict(num_levels=1, blur_filter_sizes=(0,), gradient_scales=(0.0625,), max_iterations=(1,),
                  lambda_steps=(1.0,), min_gradient_norms=(0.0,))


def _render_window(gt_states):
    """Plane keyframes at world<-keyframe states (phovo_tpu's renderer)."""
    I, D = [], []
    for s in np.asarray(gt_states, np.float64):
        a, b = render_plane(J_INTR, SHAPE, np.linalg.inv(np.asarray(jse3.pose_matrix(s))))
        I.append(a)
        D.append(b)
    return np.stack(I), np.stack(D)


def _window(n_kf=4, state_noise=0.01, grid=8, seed=2, occ_gate=np.inf):
    """tests/test_photometric_ba.py's plane window: (phovo_tpu's problem,
    the port's on the CPU, ground truth)."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((n_kf, 6), np.float32)
    gt[:, 0] = np.linspace(0.0, 0.12, n_kf)
    gt[:, 4] = np.linspace(0.0, 0.03, n_kf)
    I, D = _render_window(gt)
    init = gt + rng.normal(0.0, state_noise, gt.shape).astype(np.float32)
    init[0] = gt[0]
    jp = JP.build_photometric_window(I, D, init, J_INTR, grid=grid, occ_gate=occ_gate)
    tp = TP.build_photometric_window(I, D, init, INTR, grid=grid, occ_gate=occ_gate, device="cpu")
    return jp, tp, gt


@pytest.fixture(scope="module")
def window():
    return _window(occ_gate=0.3)


@pytest.fixture(scope="module")
def room():
    """phovo_tpu's hand-inserted room keyframes (7 at 64x96, pose noise 1
    cm), their ground truth and intrinsics in both packages' forms."""
    jkvo, gt, jintr = _room_kvo(noise=0.01)
    intr = Intrinsics(*(float(v) for v in jintr))
    snap = [k.pose.copy() for k in jkvo.keyframes]
    return jkvo, snap, gt, jintr, intr


def _port_kvo(jkvo, snap, intr):
    """The port's tracker holding the same keyframes (CPU)."""
    vo = PhotoconsistencyOdometryAnalytic(PhovoConfig(**ONE_KF_CFG), device="cpu")
    vo.set_intrinsic_matrix([[intr.fx, 0, intr.cx], [0, intr.fy, intr.cy], [0, 0, 1]])
    kvo = tkf.KeyframeVisualOdometry(vo)
    for k, pose in zip(jkvo.keyframes, snap):
        kvo.keyframes.append(tkf.Keyframe(index=k.index, frame_index=k.frame_index, timestamp=k.timestamp,
                                          intensity=k.intensity, depth=k.depth, pose=pose.copy(), device="cpu"))
    return kvo


def _restore(kvo, snap):
    for k, pose in zip(kvo.keyframes, snap):
        k.pose = pose.copy()


def _mean_err(kvo, gt):
    return float(np.mean([np.linalg.norm(k.pose[:3, 3] - g[:3, 3]) for k, g in zip(kvo.keyframes, gt)]))


@pytest.mark.parametrize("scene,grid", [("plane", 6), ("room", 8), ("room", 4)])
def test_landmark_selection_is_phovo_tpus(room, scene, grid):
    if scene == "plane":
        I, D = _render_window(np.zeros((1, 6), np.float32))
        I, D = I[0], D[0]
    else:
        k = room[0].keyframes[3]
        I, D = k.intensity, k.depth
    sel = TP.select_landmark_pixels(I, D, grid=grid)
    np.testing.assert_array_equal(sel, JP.select_landmark_pixels(I, D, grid=grid))
    valid = sel[sel[:, 0] >= 0]
    assert sel.shape == (grid * grid, 2) and len(valid) > grid * grid // 2
    H, W = I.shape
    assert (valid >= 2).all() and (valid[:, 0] < H - 2).all() and (valid[:, 1] < W - 2).all()


def test_window_builders_are_phovo_tpus(window, room):
    jp, tp, _ = window
    for field in jp._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tp, field)), np.asarray(getattr(jp, field)), err_msg=field)
    # the device builder on the room stacks, window [2, 6)
    jkvo, snap, _, jintr, intr = room
    I = np.stack([k.intensity for k in jkvo.keyframes]).astype(np.float32)
    D = np.stack([k.depth for k in jkvo.keyframes]).astype(np.float32)
    states = jse3.matrix_to_state_np(np.stack(snap)).astype(np.float32)
    sel = np.stack([JP.select_landmark_pixels(a, b, grid=GRID) for a, b in zip(I, D)])
    jprob, jv = JP.build_window_problem_device(jnp.asarray(I), jnp.asarray(D), jnp.asarray(states[2:6]),
                                               jnp.asarray(sel), 2, jintr, window=WINDOW, grid=GRID, occ_gate=0.3)
    tprob, tv = TP.build_window_problem_device(torch.from_numpy(I), torch.from_numpy(D),
                                               torch.from_numpy(states[2:6]), torch.from_numpy(sel), 2, intr,
                                               window=WINDOW, grid=GRID, occ_gate=0.3)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for field in jprob._fields:
        a, b = np.asarray(getattr(jprob, field)), np.asarray(getattr(tprob, field))
        assert a.shape == b.shape, field
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=field)


def test_global_builder_is_phovo_tpus_and_covisibility_limited():
    """max_covis observations a landmark, the host excluded, invalid
    landmarks padded, the nearest keyframes by camera centre."""
    n_kf, grid, covis = 6, 4, 3
    gt = np.zeros((n_kf, 6), np.float32)
    gt[:, 0] = np.linspace(0.0, 0.3, n_kf)
    I, D = _render_window(gt)
    jp = JP.build_photometric_global(I, D, gt, J_INTR, grid=grid, max_covis=covis, occ_gate=0.3)
    tp = TP.build_photometric_global(I, D, gt, INTR, grid=grid, max_covis=covis, occ_gate=0.3, device="cpu")
    for field in jp._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tp, field)), np.asarray(getattr(jp, field)), err_msg=field)
    G = grid * grid
    Pn = n_kf * G
    obs_pose = tp.obs_pose.numpy().reshape(Pn, covis)
    obs_point = tp.obs_point.numpy().reshape(Pn, covis)
    for j in range(Pn):
        row = obs_pose[j]
        if (row >= 0).any():
            assert j // G not in row[row >= 0] and np.all(obs_point[j] == j)
            assert np.all(np.abs(row[row >= 0] - j // G) <= covis)


@pytest.mark.parametrize("robust", [False, True])
def test_linearization_and_blocks_match_jax(window, robust):
    jp, tp, _ = window
    M, Pn = tp.pose_states.shape[0], tp.points.shape[0]
    ref = jax.jit(lambda p: JP._linearize(p, J_INTR))(jp)
    got = TP._linearize(tp, INTR)
    for a, b, what in zip(ref, got, ("r", "A", "B", "iw", "jw")):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=LIN_RTOL * max(1.0, np.abs(a).max()), err_msg=what)
    deltas = dict(robust_delta=0.1, robust_z_delta=0.02) if robust else {}
    for sparse in (False, True):
        ref = jax.jit(lambda p: JP._accumulate(p, J_INTR, M, Pn, sparse=sparse, **deltas))(jp)
        got = TP._accumulate(tp, INTR, M, Pn, sparse=sparse, **deltas)
        for a, b, what in zip(ref, got, ("U", "V", "W", "v", "w", "cost")):
            a = np.asarray(a)
            assert b.shape == a.shape, what
            np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=BLOCK_RTOL * max(1.0, np.abs(a).max()),
                                       err_msg=what)


@pytest.mark.parametrize("sparse", [False, True])
def test_one_schur_step_at_damping_one_matches_jax(window, sparse):
    jp, tp, _ = window
    M, Pn = tp.pose_states.shape[0], tp.points.shape[0]
    jb = jax.jit(lambda p: JP._accumulate(p, J_INTR, M, Pn, robust_delta=0.1, sparse=sparse))(jp)
    tb = tuple(torch.from_numpy(np.array(x)) for x in jb)
    if sparse:
        valid = jp.obs_pose >= 0
        iw, jw = jnp.where(valid, jp.obs_pose, 0), jnp.where(valid, jp.obs_point, 0)
        pa, pb = JB.build_schur_pairs(jp.obs_pose, jp.obs_point)
        ref = JB._schur_step_sparse(jp.pose_states, jp.points, (*jb[:3], iw, jw, *jb[3:]), jnp.float32(1.0), True,
                                    pair_a=pa, pair_b=pb)
        qa, qb = TB.pair_tensors(tp.obs_pose, tp.obs_point, torch.device("cpu"))
        tiw, tjw = (torch.from_numpy(np.array(x)).long() for x in (iw, jw))
        got = TB._schur_step_sparse(tp.pose_states, tp.points, (*tb[:3], tiw, tjw, *tb[3:]), torch.tensor(1.0), True,
                                    pair_a=qa, pair_b=qb)
    else:
        ref = JB._schur_step(jp.pose_states, jp.points, jb, jnp.float32(1.0), True)
        got = TB._schur_step(tp.pose_states, tp.points, tb, torch.tensor(1.0), True)
    assert np.abs(np.asarray(ref[0]) - np.asarray(jp.pose_states)).max() > 1e-4
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=STEP_ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=0, atol=STEP_ATOL)


@pytest.mark.parametrize("schur", ["dense", "sparse", "auto"])
def test_optimize_matches_jax_at_damping_one_and_by_outcome(window, schur):
    jp, tp, gt = window
    kw = dict(iterations=4, robust_delta=0.1, robust_z_delta=0.02, schur=schur)
    ref = JP.optimize_photometric_bundle(jp, J_INTR, damping=1.0, **kw)
    s, p, c = TP.optimize_photometric_bundle(tp, INTR, damping=1.0, **kw)
    np.testing.assert_allclose(s.numpy(), np.asarray(ref[0]), rtol=0, atol=DAMPED_ATOL)
    np.testing.assert_allclose(float(c), float(ref[2]), rtol=1e-4)
    # the production damping: both pull the noisy window onto the truth
    ref = JP.optimize_photometric_bundle(jp, J_INTR, damping=1e-4, **kw)
    s, _, c = TP.optimize_photometric_bundle(tp, INTR, damping=1e-4, **kw)
    err0 = np.abs(tp.pose_states.numpy() - gt).max()
    err, jerr = np.abs(s.numpy() - gt).max(), np.abs(np.asarray(ref[0]) - gt).max()
    assert np.isfinite(float(c)) and err < err0 / 3 and abs(err - jerr) < 0.1 * err0, (err0, err, jerr)


def test_jacobians_match_finite_differences():
    _, tp, _ = _window(n_kf=3, state_noise=0.005, grid=4, seed=1)
    r, A, B, iw, jw = TP._linearize(tp, INTR)
    k = int(A.abs().sum((1, 2)).argmax())
    i, j = int(iw[k]), int(jw[k])
    eps = 1e-3

    def at(states, points):
        return TP._linearize(tp._replace(pose_states=states, points=points), INTR)[0][k].numpy()

    s0, x0 = tp.pose_states, tp.points
    for c in range(9):
        d = torch.zeros(9)
        d[c] = eps
        plus = (s0.index_add(0, torch.tensor([i]), d[None, :6]), x0.index_add(0, torch.tensor([j]), d[None, 6:]))
        minus = (s0.index_add(0, torch.tensor([i]), -d[None, :6]), x0.index_add(0, torch.tensor([j]), -d[None, 6:]))
        fd = (at(*plus) - at(*minus)) / (2 * eps)
        col = A[k, :, c] if c < 6 else B[k, :, c - 6]
        np.testing.assert_allclose(col.numpy(), fd, atol=2e-2 * max(1.0, np.abs(fd).max()))


def test_perfect_window_is_stationary_and_the_gauge_stays():
    gt = np.zeros((3, 6), np.float32)
    gt[:, 0] = np.linspace(0.0, 0.08, 3)
    I, D = _render_window(gt)
    problem = TP.build_photometric_window(I, D, gt, INTR, grid=6, device="cpu")
    states, _, _ = TP.optimize_photometric_bundle(problem, INTR, iterations=4, damping=1e-4)
    np.testing.assert_allclose(states.numpy(), gt, atol=2e-3)
    np.testing.assert_array_equal(states[0].numpy(), gt[0])


def test_padding_and_out_of_view_rows_are_inert():
    _, tp, _ = _window(n_kf=3, state_noise=0.005, grid=4, seed=4)
    pad = 5
    padded = tp._replace(
        obs_pose=torch.cat([tp.obs_pose, torch.full((pad,), -1)]),
        obs_point=torch.cat([tp.obs_point, torch.zeros(pad, dtype=torch.int64)]),
        weights=torch.cat([tp.weights, torch.full((pad,), 7.0)]),
        z_weights=torch.cat([tp.z_weights, torch.full((pad,), 7.0)]),
    )
    s1, _, c1 = TP.optimize_photometric_bundle(tp, INTR, iterations=3)
    s2, _, c2 = TP.optimize_photometric_bundle(padded, INTR, iterations=3)
    np.testing.assert_allclose(s2.numpy(), s1.numpy(), atol=1e-6)
    np.testing.assert_allclose(float(c2), float(c1), rtol=1e-6, atol=1e-9)


def test_hard_window_keeps_exact_poses():
    """phovo_tpu's regression window (8 keyframes turning on all three
    axes, co-planar landmarks, short baselines) started at the truth: the
    monotone LM loop keeps it there."""
    gt = np.stack([se3.matrix_to_state_np(np.linalg.inv(se3.pose_matrix_np(
        np.array([0.12 * k, -0.08 * k, 0.06 * k, 0.05 * k, -0.03 * k, 0.04 * k])))) for k in range(8)]).astype(
        np.float32)
    I, D = _render_window(gt)
    problem = TP.build_photometric_window(I, D, gt.copy(), INTR, grid=8, device="cpu")
    refined, _, _ = TP.optimize_photometric_bundle(problem, INTR, iterations=6, damping=1e-4)
    assert float(np.abs(refined.numpy() - gt).max()) < 1e-3


def test_global_ba_tightens_poses():
    rng = np.random.default_rng(5)
    gt = np.zeros((5, 6), np.float32)
    gt[:, 0] = np.linspace(0.0, 0.16, 5)
    gt[:, 4] = np.linspace(0.0, 0.03, 5)
    I, D = _render_window(gt)
    init = gt + rng.normal(0.0, 0.01, gt.shape).astype(np.float32)
    init[0] = gt[0]
    problem = TP.build_photometric_global(I, D, init, INTR, grid=8, max_covis=3, device="cpu")
    states, _, cost = TP.optimize_photometric_bundle(problem, INTR, iterations=8, damping=1e-4)
    err0, err1 = float(np.abs(init - gt).max()), float(np.abs(states.numpy() - gt).max())
    assert np.isfinite(float(cost)) and err1 < 0.5 * err0, (err0, err1)


@pytest.mark.parametrize("robust_delta", [0.1, None])
def test_window_loop_matches_jax_scan(room, robust_delta):
    """refine_photometric_windows, window by window on the device stacks,
    against phovo_tpu's scanned program over the same windows, every one
    applied: at damping 1.0 within 1e-5, the same landmarks valid."""
    jkvo, snap, _, jintr, intr = room
    I = np.stack([k.intensity for k in jkvo.keyframes]).astype(np.float32)
    D = np.stack([k.depth for k in jkvo.keyframes]).astype(np.float32)
    states = jse3.matrix_to_state_np(np.stack(snap)).astype(np.float32)
    sel = np.stack([JP.select_landmark_pixels(a, b, grid=GRID) for a, b in zip(I, D)])
    starts = JP.window_starts(len(I), WINDOW)
    assert starts == TP.window_starts(len(I), WINDOW)
    kw = dict(window=WINDOW, grid=GRID, iterations=3, robust_delta=robust_delta, occ_gate=0.3, robust_z_delta=0.02)
    ref = JP.refine_photometric_windows(jnp.asarray(I), jnp.asarray(D), jnp.asarray(states), jnp.asarray(sel),
                                        jnp.asarray(np.asarray(starts, np.int32)), jnp.ones(len(starts), bool),
                                        jintr, jnp.float32(1.0), **kw)
    got = TP.refine_photometric_windows(torch.from_numpy(I), torch.from_numpy(D), torch.from_numpy(states),
                                        torch.from_numpy(sel), starts, intr, 1.0, **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=DAMPED_ATOL)
    assert np.abs(got[0].numpy() - states).max() > 1e-4
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


@pytest.fixture(scope="module")
def jax_finalize(room):
    """phovo_tpu's refinement of the room keyframes at damping 1.0: its
    finalize (the padded window scan, the padded global problem) and its
    sequential windows; {path: (keyframe poses, map size)}."""
    jkvo, snap, _, _, _ = room
    out = {}
    for path in REFINE_PATHS:
        _restore(jkvo, snap)
        _refine(jkvo, path, 1.0)
        out[path] = ([k.pose.copy() for k in jkvo.keyframes], len(jkvo.map_points))
    _restore(jkvo, snap)
    return out


REFINE_PATHS = ("window", "global", "sequential")


def _refine(kvo, path, damping, iterations=3):
    """One refinement path of either package's tracker: finalize's window
    or global scope, or finalize's pose graph then the windows again, on
    the sparse Schur path: phovo_tpu's sequential host-built windows, and
    the port's one windowed loop with the dense budget at 0, so that
    schur_route sends every window down the sparse path (the same float32
    pass of the poses)."""
    if path == "sequential":
        kvo.finalize()
        if isinstance(kvo, tkf.KeyframeVisualOdometry):
            with mock.patch.object(TB, "DENSE_W_BUDGET_BYTES", 0):
                kvo._refine_photometric(None, iterations, WINDOW, GRID, damping, 0.1, 0.3, 0.02)
        else:
            kvo._refine_photometric_sequential(None, iterations, WINDOW, GRID, damping, 0.1, 0.3, 0.02)
    else:
        kvo.finalize(ba_iterations=iterations, ba_window=WINDOW, ba_grid=GRID, ba_covis=3, ba_scope=path,
                     ba_damping=damping)


@pytest.mark.parametrize("path", REFINE_PATHS)
def test_refinement_at_damping_one_matches_jax(room, jax_finalize, path):
    """Each refinement path of finalize on the same keyframes (no tracked
    frame: the pose graph is the null graph) at damping 1.0: the keyframe
    poses within 1e-5 of phovo_tpu's and the map the same size."""
    jkvo, snap, _, _, intr = room
    kvo = _port_kvo(jkvo, snap, intr)
    _refine(kvo, path, 1.0)
    assert set(kvo.finalize_timings) >= {"pose_graph", "photometric_ba"}
    ref_poses, ref_n = jax_finalize[path]
    assert len(kvo.map_points) == ref_n == len(kvo.map_intensity)
    for k, pose in zip(kvo.keyframes, ref_poses):
        np.testing.assert_allclose(k.pose, pose, rtol=0, atol=DAMPED_ATOL)


@pytest.mark.parametrize("path", REFINE_PATHS)
def test_refinement_at_production_damping_contracts_in_the_median(room, path):
    """At the production damping 1e-4 one LM step amplifies float32 noise
    about 1e4-fold, and on noisy room keyframes each path's outcome is
    heavy-tailed, in both packages: after 3 iterations from 30 starts 2e-7
    apart (relative) the port's mean keyframe position error on these
    seven had medians 0.36x (window), 0.38x (global) and 0.37x
    (sequential) of the start's and single starts up to 2.2x, 1.5x and
    1.9x; phovo_tpu's, on the same keyframes at 96x128 over 48 starts,
    medians 0.13-0.18x and single starts up to 3.0x. So the check is a
    median: over the keyframes' own start and eight starts 2e-7 away, the
    median error falls below 0.75x of the start's (medians of 9 consecutive
    starts of the 30 ranged 0.25-0.63x)."""
    jkvo, snap, gt, _, intr = room
    rng = np.random.default_rng(1)
    ratios = []
    for trial in range(9):
        start = [p.copy() for p in snap]
        for p in start[1:] if trial else ():
            p[:] = se3.pose_matrix_np(se3.matrix_to_state_np(p) * (1 + 2e-7 * rng.standard_normal(6)))
        kvo = _port_kvo(jkvo, start, intr)
        err0 = _mean_err(kvo, gt)
        _refine(kvo, path, 1e-4)
        ratios.append(_mean_err(kvo, gt) / err0)
    assert np.median(ratios) < 0.75, ratios


def _room_track(traj):
    """tools/ba_ablation.py's track_scene on the port: 48 room frames at
    96x128 through the per-frame run() of the analytic backend (3 levels,
    bilinear) on the CPU; (tracker, ground-truth poses)."""
    H, W = 96, 128
    fx = float(np.float32(525.0 * W / 640.0))
    intr = Intrinsics(fx, fx, float(np.float32((W - 1) / 2)), float(np.float32((H - 1) / 2)))
    I, D, gts, ts = synthetic.make_room_sequence(intr, (H, W), 48, 1.0, 0, traj)
    cfg = PhovoConfig(num_levels=3, blur_filter_sizes=(0, 0, 0), gradient_scales=(0.0625,) * 3,
                      max_iterations=(6, 10, 12), lambda_steps=(1.0,) * 3, min_gradient_norms=(1e-10,) * 3,
                      sampling="bilinear")
    vo = PhotoconsistencyOdometryAnalytic(cfg, device="cpu")
    vo.set_intrinsic_matrix([[fx, 0, intr.cx], [0, fx, intr.cy], [0, 0, 1]])
    kvo = tkf.KeyframeVisualOdometry(vo)
    for _ in kvo.run(RGBDFrame(float(ts[k]), float(ts[k]), I[k], D[k]) for k in range(48)):
        pass
    return kvo, np.stack(gts)


def _ate(kvo, gts):
    P = np.stack([kvo.keyframes[0].pose] + [tf.pose for tf in kvo.tracked])[:, :3, 3]
    Q = gts[:, :3, 3]
    R, t = horn_align(P, Q)
    return float(np.sqrt(np.mean(np.sum((P @ R.T + t - Q) ** 2, axis=1))))


@pytest.mark.parametrize("traj,improvement", [("forward", 0.6), ("loop", 0.85)])
def test_ba_earns_its_keep_on_the_room(traj, improvement):
    """phovo_tpu's bound (tests/test_photometric_ba.py): on the room scene
    the default windowed BA (Huber 0.1, occlusion gate) beats the pose
    graph alone on ATE, forward (measured 0.0210 -> 0.0109 m, phovo_tpu
    0.0210 -> 0.0111) and on the out-and-back loop with its closures
    (0.0307 -> 0.0212, phovo_tpu 0.0307 -> 0.0228)."""
    kvo, gts = _room_track(traj)
    if traj == "loop":
        assert len(kvo.loop_closures) >= 3
    snap = [k.pose.copy() for k in kvo.keyframes]
    kvo.finalize(ba_iterations=0)
    pg = _ate(kvo, gts)
    _restore(kvo, snap)
    kvo.finalize(ba_iterations=3)
    ba3 = _ate(kvo, gts)
    assert pg < 0.05 and ba3 < improvement * pg, (pg, ba3)


def test_refusals(window, monkeypatch):
    jp, tp, _ = window
    with pytest.raises(ValueError, match="schur"):
        TP.optimize_photometric_bundle(tp, INTR, iterations=1, schur="bogus")
    # a one-rank mesh (no process group) runs the unsharded code: its bits
    one = make_mesh(1, devices=["cpu"])
    for schur in ("dense", "sparse"):
        got = TP.optimize_photometric_bundle(tp, INTR, mesh=one, iterations=2, schur=schur)
        ref = TP.optimize_photometric_bundle(tp, INTR, iterations=2, schur=schur)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    with pytest.raises(ValueError, match="world size 1"):
        make_mesh(2)
    I, D = _render_window(np.zeros((2, 6), np.float32))
    with pytest.raises(ValueError, match="at least 2"):
        TP.build_photometric_global(I[:1], D[:1], np.zeros((1, 6)), INTR, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (TP.build_photometric_window, TP.build_photometric_global):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            build(I, D, np.zeros((2, 6), np.float32), INTR)
