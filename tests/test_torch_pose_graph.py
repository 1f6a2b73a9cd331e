"""The pose graph: phovo_tpu_torch's optimize_pose_graph (dense and CG,
bucketed and not), edge_residual and chain_to_graph against phovo_tpu's on
the CPU, on the same graphs (tests/test_parallel.py's noisy chains with a
loop edge).

Tolerances: states 1e-5 absolute against phovo_tpu (both solve in float32,
the residual's 3x4 products and the solves in another order), CG against
dense 2e-4 (tests/test_keyframe.py's level for the two solvers),
bucketed against unbucketed 1e-6 (padding adds exact zeros to every sum;
the dense solve of the padded system may round otherwise).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phovo_tpu.ops import se3 as jse3
from phovo_tpu.parallel import pose_graph as jpg
from phovo_tpu_torch.ops import se3
from phovo_tpu_torch.parallel import pose_graph as tpg
from phovo_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)


def _noisy_chain(n=9, seed=13, noise=0.02):
    rng = np.random.default_rng(seed)
    rel = np.stack([
        np.array([0.1, 0.02, -0.01, 0.05, -0.02, 0.01]) + 0.01 * rng.standard_normal(6)
        for _ in range(n - 1)
    ]).astype(np.float32)
    return rel + noise * np.random.default_rng(seed + 1).standard_normal(rel.shape).astype(np.float32)


def _graphs(n=9, seed=13, loops=((0, 8),), loop_weight=10.0):
    """The same chain graph for both packages: phovo_tpu's chain_to_graph,
    its arrays handed to the port as numpy."""
    rel = _noisy_chain(n, seed)
    closures = [(i, j, np.zeros(6, np.float32)) for i, j in loops]
    jg = jpg.chain_to_graph(rel, closures, loop_weight=loop_weight)
    tg = tpg.PoseGraph(*(np.asarray(x) for x in jg))
    return jg, tg, rel, closures


def test_edge_residual_matches_and_vanishes_on_consistent_poses():
    s_i = np.array([0.1, 0.2, 0.3, 0.1, -0.2, 0.15], np.float32)
    rel = np.array([0.05, -0.02, 0.1, 0.02, 0.01, -0.03], np.float32)
    s_j = se3.matrix_to_state_np(se3.pose_matrix_np(s_i) @ se3.pose_matrix_np(rel)).astype(np.float32)
    r = tpg.edge_residual(*(torch.from_numpy(x) for x in (s_i, s_j, rel)))
    np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-5)
    z = rel + 0.01
    np.testing.assert_allclose(
        tpg.edge_residual(*(torch.from_numpy(x) for x in (s_i, s_j, z))).numpy(),
        np.asarray(jpg.edge_residual(jnp.asarray(s_i), jnp.asarray(s_j), jnp.asarray(z))),
        rtol=0, atol=1e-6,
    )


def test_chain_to_graph_matches():
    _, _, rel, closures = _graphs()
    jg = jpg.chain_to_graph(rel, closures, loop_weight=10.0)
    tg = tpg.chain_to_graph(torch.from_numpy(rel), closures, loop_weight=10.0)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


@pytest.mark.parametrize("solver,bucket", [("dense", False), ("dense", True), ("cg", False), ("cg", True)])
def test_optimize_pose_graph_matches_jax(solver, bucket):
    jg, tg, _, _ = _graphs()
    kw = dict(iterations=5, damping=1e-4, solver=solver, cg_iterations=200, cg_tol=1e-12, bucket=bucket)
    js, jc = jpg.optimize_pose_graph(jg, **kw)
    ts, tc = tpg.optimize_pose_graph(tg, device="cpu", **kw)
    assert ts.shape == (9, 6) and ts.dtype == torch.float32 and ts.device.type == "cpu"
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-4, atol=1e-8)


def test_bucketed_matches_unbucketed_and_cg_matches_dense():
    _, tg, _, _ = _graphs()
    kw = dict(iterations=5, damping=1e-4, cg_iterations=200, cg_tol=1e-12, device="cpu")
    dense = tpg.optimize_pose_graph(tg, solver="dense", **kw)[0]
    cg = tpg.optimize_pose_graph(tg, solver="cg", **kw)[0]
    for solver, ref in (("dense", dense), ("cg", cg)):
        bucketed = tpg.optimize_pose_graph(tg, solver=solver, bucket=True, **kw)[0]
        np.testing.assert_allclose(bucketed.numpy(), ref.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(cg.numpy(), dense.numpy(), rtol=0, atol=2e-4)


def test_pose_graph_closes_a_loop_like_jax():
    """tests/test_parallel.py's loop: a noisy chain with a perfect loop edge
    at weight 100; the cost falls and the loop edge is satisfied, as in
    phovo_tpu, and the states agree with its."""
    rng = np.random.default_rng(0)
    true_rel = np.stack([
        np.array([0.1, 0.02, -0.01, 0.05, -0.02, 0.01]) + 0.01 * rng.standard_normal(6) for _ in range(7)
    ]).astype(np.float32)
    noisy = true_rel + 0.02 * np.random.default_rng(1).standard_normal(true_rel.shape).astype(np.float32)
    T = np.eye(4)
    for k in range(len(true_rel)):
        T = T @ np.linalg.inv(se3.pose_matrix_np(true_rel[k]))
    z_loop = se3.matrix_to_state_np(T).astype(np.float32)
    graph = tpg.chain_to_graph(torch.from_numpy(noisy), [(0, 7, z_loop)], loop_weight=100.0)
    _, cost0 = tpg.optimize_pose_graph(graph, iterations=1, damping=1e-4)
    states, cost = tpg.optimize_pose_graph(graph, iterations=15, damping=1e-4)
    assert float(cost) < float(cost0)
    assert float(tpg.edge_residual(states[0], states[7], torch.from_numpy(z_loop)).norm()) < 0.02
    jstates, _ = jpg.optimize_pose_graph(
        jpg.chain_to_graph(noisy, [(0, 7, z_loop)], loop_weight=100.0), iterations=15, damping=1e-4
    )
    np.testing.assert_allclose(states.numpy(), np.asarray(jstates), rtol=0, atol=1e-5)


def test_mesh_and_unknown_solver_raise():
    """A one-rank mesh (no process group) runs the unsharded solve, bit for
    bit, with either solver; an unknown solver raises."""
    _, tg, _, _ = _graphs()
    one = make_mesh(1, devices=["cpu"])
    for solver in ("dense", "cg"):
        got = tpg.optimize_pose_graph(tg, mesh=one, iterations=3, solver=solver, device="cpu")
        ref = tpg.optimize_pose_graph(tg, iterations=3, solver=solver, device="cpu")
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    with pytest.raises(ValueError, match="unknown solver"):
        tpg.optimize_pose_graph(tg, solver="lu")
    # the matrix_to_state_np twin the keyframe back end builds graphs with
    T = se3.pose_matrix_np(np.array([[0.1, -0.2, 0.3, 0.4, -0.1, 0.2]]))
    np.testing.assert_allclose(se3.matrix_to_state_np(T), np.asarray(jse3.matrix_to_state_np(T)), atol=0)
