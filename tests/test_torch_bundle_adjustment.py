"""The reprojection bundle adjustment (phovo_tpu_torch/parallel/
bundle_adjustment.py) against phovo_tpu's on the CPU, on the same
synthetic problems (make_synthetic_ba: the same random draws; the port
projects in torch, phovo_tpu in XLA).

Held, each tolerance beside the reading that set it:
  * the problem's arrays equal, the pixels within 1e-4 (a float32 ulp at
    u ~ 300, 3e-5 measured: the projections' cos and sin round apart);
  * the weighted residuals, Jacobians and the {U, V, W, v, w, cost} blocks
    within 1e-5 of each block's largest entry (float32 sums in another
    order; 2e-6 measured);
  * one Schur step at damping 1.0, dense and sparse: states and points
    within 1e-6 (2e-7 measured), and the sparse pair list equal;
  * whole runs (4 iterations at damping 1e-6): states and points within
    5e-5 of phovo_tpu's (1.6e-5 and 8e-6 measured on the sparse-visibility
    problem, whose pixel noise keeps the cost at 380; 2e-7 on the others);
  * schur='auto' routes as phovo_tpu's under the same budgets;
and, on the port alone, phovo_tpu's own invariants: the Schur step equals
the float64 full-system solve, padding is inert, an unobserved landmark
stays put, the gauge pose stays put, a rank-deficient landmark does not
void the update, and noiseless problems converge to the ground truth.
"""

import jax
import numpy as np
import pytest
import torch

import phovo_tpu.parallel.bundle_adjustment as JB
from phovo_tpu.ops.camera import TUM_DEFAULT as J_TUM
from phovo_tpu_torch.ops import se3
from phovo_tpu_torch.ops.camera import TUM_DEFAULT
from phovo_tpu_torch.parallel import bundle_adjustment as TB
from phovo_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

CPU = torch.device("cpu")
# make_synthetic_ba's keyword sets: phovo_tpu's test problems (dense
# visibility) and a sparse-visibility one with pixel and depth noise
PROBLEMS = {
    "small": dict(n_poses=4, n_points=12, state_noise=0.03, point_noise=0.05, seed=1),
    "dense": dict(n_poses=5, n_points=24, seed=7),
    "sparse_vis": dict(n_poses=6, n_points=300, obs_per_pose=50, pixel_noise=0.5, depth_noise=0.01, seed=4),
}
BLOCK_RTOL = 1e-5
STEP_ATOL = 1e-6
RUN_STATE_ATOL = 5e-5
RUN_POINT_ATOL = 5e-5


def _pair(name):
    """(phovo_tpu's problem, the port's as CPU tensors)."""
    jp, _, _ = JB.make_synthetic_ba(**PROBLEMS[name])
    tp, _, _ = TB.make_synthetic_ba(**PROBLEMS[name])
    return jp, _tensors(tp)


def _tensors(problem):
    return TB.BAProblem(*(torch.from_numpy(np.asarray(x)).to(torch.int64 if k in (2, 3) else torch.float32)
                          for k, x in enumerate(problem)))


def _jax_blocks(jp, M, Pn, robust_delta, sparse):
    """phovo_tpu's _accumulate_shard of a problem, jitted."""
    def blocks(*arrays):
        return JB._accumulate_shard(*arrays, J_TUM, M, Pn, robust_delta=robust_delta, sparse=sparse)

    return jax.jit(blocks)(jp.pose_states, jp.points, jp.obs_pose, jp.obs_point, jp.obs_uv, jp.obs_z, jp.weights,
                           jp.z_weights)


@pytest.fixture(scope="module")
def jax_runs():
    """phovo_tpu's optimize_bundle of each problem, dense and sparse, 4
    iterations at its default damping."""
    out = {}
    for name in PROBLEMS:
        jp, _, _ = JB.make_synthetic_ba(**PROBLEMS[name])
        for schur in ("dense", "sparse"):
            out[name, schur] = tuple(np.asarray(x) for x in JB.optimize_bundle(jp, J_TUM, iterations=4, schur=schur))
    return out


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_synthetic_problem_is_phovo_tpus(name):
    jp, jg, jx = JB.make_synthetic_ba(**PROBLEMS[name])
    tp, tg, tx = TB.make_synthetic_ba(**PROBLEMS[name])
    np.testing.assert_array_equal(tg, np.asarray(jg))
    np.testing.assert_array_equal(tx, np.asarray(jx))
    for field in jp._fields:
        a, b = np.asarray(getattr(jp, field)), np.asarray(getattr(tp, field))
        assert a.shape == b.shape and b.dtype == a.dtype, field
        if field == "obs_uv":
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)
        elif field == "z_weights":  # (fx / z)^2 of float32 depths an ulp apart
            np.testing.assert_allclose(b, a, rtol=2e-7, atol=0)
        else:
            np.testing.assert_array_equal(b, a, err_msg=field)


def test_project_point_matches_jax_and_round_trips():
    """The projection of phovo_tpu, and a landmark backprojected through a
    pose lands on its pixel again."""
    state = np.array([0.05, -0.02, 0.01, 0.03, -0.02, 0.01], np.float32)
    T = se3.pose_matrix_np(state)
    u, v, z = 200.0, 150.0, 2.5
    pc = np.array([(u - TUM_DEFAULT.cx) * z / TUM_DEFAULT.fx, (v - TUM_DEFAULT.cy) * z / TUM_DEFAULT.fy, z])
    X = (T[:3, :3] @ pc + T[:3, 3]).astype(np.float32)
    uv, depth = TB.project_point(torch.from_numpy(state), torch.from_numpy(X), TUM_DEFAULT)
    np.testing.assert_allclose(uv.numpy(), [u, v], atol=1e-3)
    np.testing.assert_allclose(float(depth), z, atol=1e-5)
    juv, jz = JB.project_point(state, X, J_TUM)
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(depth), float(jz), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,robust_delta,sparse", [
    ("small", None, False), ("dense", 3.0, False), ("sparse_vis", None, True), ("sparse_vis", 3.0, False),
])
def test_linearization_and_blocks_match_jax(name, robust_delta, sparse):
    jp, tp = _pair(name)
    M, Pn = tp.pose_states.shape[0], tp.points.shape[0]
    jr = jax.jit(lambda *a: JB._linearize_obs(*a, J_TUM))(jp.pose_states, jp.points, jp.obs_pose, jp.obs_point,
                                                          jp.obs_uv, jp.obs_z, jp.weights, jp.z_weights)
    tr = TB._linearize_obs(tp.pose_states, tp.points, tp.obs_pose, tp.obs_point, tp.obs_uv, tp.obs_z, tp.weights,
                           tp.z_weights, TUM_DEFAULT)
    for a, b, what in zip(jr, tr, ("r", "A", "B", "iw", "jw")):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=BLOCK_RTOL * max(1.0, np.abs(a).max()), err_msg=what)
    jb = _jax_blocks(jp, M, Pn, robust_delta, sparse)
    tb = TB._accumulate(tp.pose_states, tp.points, tp, TUM_DEFAULT, M, Pn, robust_delta, sparse)
    for a, b, what in zip(jb, tb, ("U", "V", "W", "v", "w", "cost")):
        a = np.asarray(a)
        assert b.shape == a.shape, what
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=BLOCK_RTOL * max(1.0, np.abs(a).max()), err_msg=what)


@pytest.mark.parametrize("sparse", [False, True])
def test_one_schur_step_at_damping_one_matches_jax(sparse):
    """One step from the same blocks (phovo_tpu's, handed to both)."""
    import jax.numpy as jnp

    jp, tp = _pair("dense")
    M, Pn = tp.pose_states.shape[0], tp.points.shape[0]
    jb = _jax_blocks(jp, M, Pn, None, sparse)
    tb = tuple(torch.from_numpy(np.array(x)) for x in jb)
    if sparse:
        pa, pb = JB.build_schur_pairs(jp.obs_pose, jp.obs_point)
        qa, qb = TB.pair_tensors(tp.obs_pose, tp.obs_point, CPU)
        iw, jw = jnp.asarray(jp.obs_pose), jnp.asarray(jp.obs_point)
        ref = JB._schur_step_sparse(jp.pose_states, jp.points, (*jb[:3], iw, jw, *jb[3:]), jnp.float32(1.0), True,
                                    pair_a=pa, pair_b=pb)
        got = TB._schur_step_sparse(tp.pose_states, tp.points, (*tb[:3], tp.obs_pose, tp.obs_point, *tb[3:]),
                                    torch.tensor(1.0), True, pair_a=qa, pair_b=qb)
    else:
        ref = JB._schur_step(jp.pose_states, jp.points, jb, jnp.float32(1.0), True)
        got = TB._schur_step(tp.pose_states, tp.points, tb, torch.tensor(1.0), True)
    moved = np.abs(np.asarray(ref[0]) - np.asarray(jp.pose_states)).max()
    assert moved > 1e-4  # the step does something
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=STEP_ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=0, atol=STEP_ATOL)


@pytest.mark.parametrize("name,holes", [("dense", True), ("sparse_vis", True), ("sparse_vis", False), ("empty", True)])
def test_schur_pairs_match_jax(name, holes):
    """The vectorized pair builder gives phovo_tpu's loop's pairs, without
    its -1 padding tail (one -1 row where there is no pair); padding rows
    (obs_pose -1, the holes) join no pair."""
    if name == "empty":
        op, ol = np.array([-1, -1], np.int32), np.array([0, 1], np.int32)
    else:
        jp, _ = _pair(name)
        op, ol = np.asarray(jp.obs_pose), np.asarray(jp.obs_point)
        if holes:
            op = op.copy()
            op[::7] = -1
    pa, pb = (np.asarray(x) for x in JB.build_schur_pairs(op, ol))
    qa, qb = TB.build_schur_pairs(op, ol)
    n = int((pa >= 0).sum())
    assert (pa[n:] == -1).all()  # phovo_tpu's real pairs come first
    np.testing.assert_array_equal(qa[:n], pa[:n])
    np.testing.assert_array_equal(qb[:n], pb[:n])
    assert len(qa) == len(qb) == max(n, 1) and qa.dtype == qb.dtype == np.int32
    assert n > 0 or (qa == -1).all()


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("schur", ["dense", "sparse", "auto"])
def test_optimize_bundle_matches_jax(jax_runs, name, schur):
    ref = jax_runs[name, "dense" if schur == "auto" else schur]
    _, tp = _pair(name)
    s, p, c = TB.optimize_bundle(tp, TUM_DEFAULT, iterations=4, schur=schur)
    assert s.device.type == "cpu"  # the problem's tensors' device
    np.testing.assert_allclose(s.numpy(), ref[0], rtol=0, atol=RUN_STATE_ATOL)
    np.testing.assert_allclose(p.numpy(), ref[1], rtol=0, atol=RUN_POINT_ATOL)
    np.testing.assert_allclose(float(c), float(ref[2]), rtol=1e-3, atol=1e-7)


def test_robust_run_matches_jax():
    jp, tp = _pair("sparse_vis")
    ref = JB.optimize_bundle(jp, J_TUM, iterations=4, robust_delta=3.0)
    s, p, c = TB.optimize_bundle(tp, TUM_DEFAULT, iterations=4, robust_delta=3.0)
    np.testing.assert_allclose(s.numpy(), np.asarray(ref[0]), rtol=0, atol=RUN_STATE_ATOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(ref[1]), rtol=0, atol=RUN_POINT_ATOL)
    plain = TB.optimize_bundle(tp, TUM_DEFAULT, iterations=4)
    assert float(c) < float(plain[2])  # the Huber rows weigh less


def test_auto_routing_is_phovo_tpus(monkeypatch):
    """schur='auto' takes the dense path under the budget (the dense bits)
    and the sparse path past it, at the same budgets as phovo_tpu."""
    seen = {}
    core, jcore = TB._optimize_bundle_core, JB._optimize_bundle_jit

    def spy(problem, intr, damping, pair_a, pair_b, **kw):
        seen["port"] = pair_a is not None
        return core(problem, intr, damping, pair_a, pair_b, **kw)

    def jspy(problem, intr, damping, pair_a, pair_b, **kw):
        seen["jax"] = pair_a is not None
        return jcore(problem, intr, damping, pair_a, pair_b, **kw)

    monkeypatch.setattr(TB, "_optimize_bundle_core", spy)
    monkeypatch.setattr(JB, "_optimize_bundle_jit", jspy)
    _, tp = _pair("dense")
    a = TB.optimize_bundle(tp, TUM_DEFAULT, iterations=2, schur="auto")
    d = TB.optimize_bundle(tp, TUM_DEFAULT, iterations=2, schur="dense")
    assert all(torch.equal(x, y) for x, y in zip(a, d))
    kw = dict(n_poses=2, n_points=1000, state_noise=0.01, point_noise=0.01, seed=0)
    jbig, _, _ = JB.make_synthetic_ba(**kw)
    big = _tensors(TB.make_synthetic_ba(**kw)[0])
    footprint = 2 * 2 * 1000 * 18 * 4
    for budget, sparse in ((256e6, False), (footprint, False), (footprint - 1, True)):
        monkeypatch.setattr(TB, "DENSE_W_BUDGET_BYTES", budget)
        monkeypatch.setattr(JB, "DENSE_W_BUDGET_BYTES", budget)
        _, _, c = TB.optimize_bundle(big, TUM_DEFAULT, iterations=1, schur="auto")
        JB.optimize_bundle(jbig, J_TUM, iterations=1, schur="auto")
        assert seen == {"port": sparse, "jax": sparse} and np.isfinite(float(c))
        assert TB.dense_w_fits(2, 1000) == JB.dense_w_fits(2, 1000) == (not sparse)


def test_schur_step_matches_full_dense_solve():
    """One LM step (iterations=1) equals the float64 (6M + 3P) solve; the
    returned cost is the accepted trial's, below the oracle's pre-step
    cost."""
    _, tp = _pair("small")
    s_d, p_d, cost_d = TB.dense_gn_step(tp, TUM_DEFAULT, damping=1e-6)
    s_s, p_s, cost_s = TB.optimize_bundle(tp, TUM_DEFAULT, iterations=1, damping=1e-6)
    assert float(cost_s) < cost_d
    np.testing.assert_allclose(s_s.numpy(), s_d.numpy(), atol=2e-4)
    np.testing.assert_allclose(p_s.numpy(), p_d.numpy(), atol=2e-4)


@pytest.mark.parametrize("schur", ["dense", "sparse"])
def test_recovers_ground_truth(schur):
    problem, gt_states, gt_points = TB.make_synthetic_ba(n_poses=5, n_points=40, state_noise=0.02, point_noise=0.03,
                                                         seed=0)
    states, points, cost = TB.optimize_bundle(problem, TUM_DEFAULT, iterations=15, damping=1e-8, schur=schur,
                                              device="cpu")
    assert float(cost) < 1e-4
    np.testing.assert_allclose(states.numpy(), gt_states, atol=1e-3)
    np.testing.assert_allclose(points.numpy(), gt_points, atol=2e-3)


def test_noisy_cost_falls_with_iterations():
    problem, _, _ = TB.make_synthetic_ba(n_poses=5, n_points=40, pixel_noise=0.5, seed=2)
    _, _, c1 = TB.optimize_bundle(problem, TUM_DEFAULT, iterations=1, device="cpu")
    _, _, c8 = TB.optimize_bundle(problem, TUM_DEFAULT, iterations=8, device="cpu")
    assert np.isfinite(float(c8)) and float(c8) < float(c1)


@pytest.mark.parametrize("schur", ["dense", "sparse"])
def test_padding_observations_are_inert(schur):
    _, tp = _pair("small")
    pad = 7
    padded = tp._replace(
        obs_pose=torch.cat([tp.obs_pose, torch.full((pad,), -1)]),
        obs_point=torch.cat([tp.obs_point, torch.zeros(pad, dtype=torch.int64)]),
        obs_uv=torch.cat([tp.obs_uv, torch.full((pad, 2), 123.0)]),
        obs_z=torch.cat([tp.obs_z, torch.full((pad,), 9.0)]),
        weights=torch.cat([tp.weights, torch.zeros(pad)]),
        z_weights=torch.cat([tp.z_weights, torch.zeros(pad)]),
    )
    s1, p1, c1 = TB.optimize_bundle(tp, TUM_DEFAULT, iterations=4, schur=schur)
    s2, p2, c2 = TB.optimize_bundle(padded, TUM_DEFAULT, iterations=4, schur=schur)
    np.testing.assert_allclose(s2.numpy(), s1.numpy(), atol=1e-6)
    np.testing.assert_allclose(p2.numpy(), p1.numpy(), atol=1e-6)
    np.testing.assert_allclose(float(c2), float(c1), rtol=1e-6)


@pytest.mark.parametrize("schur", ["dense", "sparse"])
def test_unobserved_landmark_is_frozen(schur):
    _, tp = _pair("small")
    grown = tp._replace(points=torch.cat([tp.points, torch.tensor([[9.0, 9.0, 9.0]])]))
    _, points, _ = TB.optimize_bundle(grown, TUM_DEFAULT, iterations=3, schur=schur)
    np.testing.assert_array_equal(points[-1].numpy(), [9.0, 9.0, 9.0])


def test_gauge_anchor_fixed():
    problem, _, _ = TB.make_synthetic_ba(n_poses=5, n_points=30, seed=6)
    states, _, _ = TB.optimize_bundle(problem, TUM_DEFAULT, iterations=6, device="cpu")
    np.testing.assert_allclose(states[0].numpy(), problem.pose_states[0], atol=1e-7)


def test_rank_deficient_landmark_does_not_void_the_update():
    """A pixel-only landmark on pose 0's optical axis has a V block with a
    zero diagonal entry; the absolute floor keeps its inverse finite, so
    the finite guard does not discard the whole update."""
    _, tp = _pair("small")
    T0 = se3.pose_matrix_np(tp.pose_states[0].numpy())
    p_w = torch.from_numpy((T0 @ np.array([0.0, 0.0, 2.0, 1.0]))[:3].astype(np.float32))
    n = tp.points.shape[0]
    degenerate = tp._replace(
        points=torch.cat([tp.points, p_w[None]]),
        obs_pose=torch.cat([tp.obs_pose, torch.zeros(1, dtype=torch.int64)]),
        obs_point=torch.cat([tp.obs_point, torch.full((1,), n)]),
        obs_uv=torch.cat([tp.obs_uv, torch.tensor([[TUM_DEFAULT.cx, TUM_DEFAULT.cy]])]),
        obs_z=torch.cat([tp.obs_z, torch.tensor([2.0])]),
        weights=torch.cat([tp.weights, torch.ones(1)]),
        z_weights=torch.cat([tp.z_weights, torch.zeros(1)]),
    )
    _, _, c0 = TB.optimize_bundle(degenerate, TUM_DEFAULT, iterations=0)
    states, _, c6 = TB.optimize_bundle(degenerate, TUM_DEFAULT, iterations=6)
    assert float(c6) < 0.5 * float(c0)
    assert not np.allclose(states[1:].numpy(), degenerate.pose_states[1:].numpy())


def test_sparse_path_at_ten_thousand_observations():
    """phovo_tpu's capacity case (16 poses x 2000 landmarks, 32,000
    observations, sparse W) converges finitely toward the truth."""
    problem, _, _ = TB.make_synthetic_ba(n_poses=16, n_points=2000, seed=1)
    assert len(problem.obs_pose) >= 10_000
    _, _, c = TB.optimize_bundle(problem, TUM_DEFAULT, iterations=3, schur="sparse", device="cpu")
    assert np.isfinite(float(c)) and float(c) < 1.0


def test_lm_loop_is_monotone_and_counts_builds():
    """iterations + 1 builds; the returned cost never above the first
    build's, with a rejection forced by a step that overshoots."""
    _, tp = _pair("dense")
    M, Pn = tp.pose_states.shape[0], tp.points.shape[0]
    builds = []

    def build(states, points):
        builds.append(1)
        return TB._accumulate(states, points, tp, TUM_DEFAULT, M, Pn)

    def overshoot(states, points, blocks, lam, fixed_first):
        s, p, c = TB._schur_step(states, points, blocks, lam, fixed_first)
        return states + 50.0 * (s - states), points, c

    c0 = float(build(tp.pose_states, tp.points)[-1])
    builds.clear()
    _, _, c = TB._lm_iterate(build, tp.pose_states, tp.points, 3, 1e-6, True, overshoot)
    assert len(builds) == 4 and float(c) <= c0


def test_refusals(monkeypatch):
    _, tp = _pair("small")
    with pytest.raises(ValueError, match="schur"):
        TB.optimize_bundle(tp, TUM_DEFAULT, iterations=1, schur="bogus")
    # a one-rank mesh (no process group) runs the unsharded code: its bits
    one = make_mesh(1, devices=["cpu"])
    for schur in ("dense", "sparse"):
        got = TB.optimize_bundle(tp, TUM_DEFAULT, mesh=one, iterations=2, schur=schur)
        ref = TB.optimize_bundle(tp, TUM_DEFAULT, iterations=2, schur=schur)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    problem, _, _ = TB.make_synthetic_ba(n_poses=2, n_points=8)
    assert isinstance(problem.pose_states, np.ndarray)  # host arrays: the card by default
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        TB.optimize_bundle(problem, TUM_DEFAULT, iterations=1)
