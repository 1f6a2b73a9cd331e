"""Pose-graph optimization of keyframe poses (torch port of
phovo_tpu/parallel/pose_graph.py, single device).

Keyframe poses are optimized against relative-pose constraints (odometry
edges and loop closures) by Gauss-Newton, on the device the caller names
(the keyframe tracker passes its odometry's). Each constraint (i, j, z_ij)
says pose_matrix(z_ij) should equal T_i^{-1} T_j, in the front end's
[x, y, z, yaw, pitch, roll] parameterization. The per-edge 6x6 Jacobians
come from torch.func.jacfwd, vmapped over the edges; their blocks are
accumulated with scatter-adds (index_put_ with accumulate, duplicate edges
add up). Two solvers, as in phovo_tpu: the dense (6M, 6M) solve and a
matrix-free block-Jacobi-preconditioned conjugate gradient. phovo_tpu
solves in XLA, not in Pallas, so no kernel of the repository is involved:
the dense solve is torch.linalg.solve.

With a mesh (parallel/mesh.py) the edges are sharded over all its ranks,
flattened: each rank linearizes its edges, the dense solver all-reduces
its (H, g, cost) blocks once a Gauss-Newton step and the CG solver its
(M, 6) product once a Hessian application, and every rank then solves
the same system.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from phovo_tpu_torch.models.base import DEFAULT_DEVICE
from phovo_tpu_torch.ops import se3
from phovo_tpu_torch.parallel.mesh import psum, shard_bounds


class PoseGraph(NamedTuple):
    states: torch.Tensor  # (M, 6) current pose estimates (world <- keyframe)
    edges_i: torch.Tensor  # (K,) int source keyframe index (-1: padding)
    edges_j: torch.Tensor  # (K,) int target keyframe index
    measurements: torch.Tensor  # (K, 6) measured state of T_i^{-1} T_j
    weights: torch.Tensor  # (K,) information weight per edge


def edge_residual(si: torch.Tensor, sj: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """6-vector error of one constraint: the state of Z^{-1} (T_i^{-1} T_j),
    in phovo_tpu's product order (rigid inverses, then 3x4 products)."""
    Ti, Tj, Z = se3.pose_matrix(si), se3.pose_matrix(sj), se3.pose_matrix(z)

    def inv_apply(A, R, t):
        # inverse(A) @ [R | t] for rigid A: A_R^T R and A_R^T t - A_R^T A_t
        AR = A[..., :3, :3].transpose(-1, -2)
        return AR @ R, AR @ t - AR @ A[..., :3, 3:]

    R_ij, t_ij = inv_apply(Ti, Tj[..., :3, :3], Tj[..., :3, 3:])
    R, t = inv_apply(Z, R_ij, t_ij)
    # matrix_to_state reads the rotation block and the translation column
    return se3.matrix_to_state(torch.cat([R, t], dim=-1))


def _edge_jacobians(si, sj, z, w):
    """Residual and d/dsi, d/dsj of one edge (forward mode, 12 tangents),
    each scaled by sqrt(w)."""
    r = edge_residual(si, sj, z)
    Ji, Jj = torch.func.jacfwd(edge_residual, argnums=(0, 1))(si, sj, z)
    sw = torch.sqrt(w)
    return r * sw, Ji * sw, Jj * sw


def _linearize(states, ei, ej, z, w):
    """Every edge's weighted residual (K, 6) and Jacobian blocks (K, 6, 6),
    padding edges (i = -1) zeroed; the gather indices (K,) of both ends."""
    valid = ei >= 0
    iw = torch.where(valid, ei, 0).long()
    jw = torch.where(valid, ej, 0).long()
    r, Ji, Jj = torch.func.vmap(_edge_jacobians)(states[iw], states[jw], z, w)
    mask = valid.to(states.dtype)
    return r * mask[:, None], Ji * mask[:, None, None], Jj * mask[:, None, None], iw, jw


def _scatter(out, index, values):
    """out[index[k]] += values[k] for every k (duplicates add up)."""
    return out.index_put_(index, values, accumulate=True)


def _dense_gn_step(states, ei, ej, z, w, damping, fixed_first, mesh=None):
    """One Gauss-Newton step on the dense (6M, 6M) system; with a mesh the
    edge shards' blocks are summed in one all_reduce."""
    M = states.shape[0]
    r, Ji, Jj, iw, jw = _linearize(states, ei, ej, z, w)
    JiT, JjT = Ji.transpose(1, 2), Jj.transpose(1, 2)
    H = states.new_zeros((M, M, 6, 6))
    _scatter(H, (iw, iw), JiT @ Ji)
    _scatter(H, (iw, jw), JiT @ Jj)
    _scatter(H, (jw, iw), JjT @ Ji)
    _scatter(H, (jw, jw), JjT @ Jj)
    g = states.new_zeros((M, 6))
    _scatter(g, (iw,), (JiT @ r[:, :, None])[..., 0])
    _scatter(g, (jw,), (JjT @ r[:, :, None])[..., 0])
    H, g, cost = psum(mesh, (H, g, torch.sum(r * r)))
    Hd = H.permute(0, 2, 1, 3).reshape(6 * M, 6 * M)
    gd = g.reshape(6 * M)
    if fixed_first:
        # gauge: pose 0 pinned by zeroing its rows and columns, unit diagonal
        mask = torch.ones(6 * M, dtype=states.dtype, device=states.device)
        mask[:6] = 0.0
        Hd = Hd * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
        gd = gd * mask
    Hd = Hd + damping * torch.eye(6 * M, dtype=states.dtype, device=states.device)
    step = torch.linalg.solve(Hd, gd)
    step = torch.where(torch.isfinite(step).all(), step, torch.zeros_like(step))
    return states - step.reshape(M, 6), cost


def _cg_gn_step(states, ei, ej, z, w, damping, fixed_first, cg_iterations, cg_tol, mesh=None):
    """One Gauss-Newton step with a matrix-free preconditioned CG inner
    solve of (J^T J + damping I) step = J^T r: each CG iteration applies
    J^T J edge by edge (two 6x6 block products and a scatter-add); the
    preconditioner inverts the diagonal 6x6 blocks. The gauge (pose 0,
    fixed_first) is pinned by projection, which keeps every iterate in the
    fixed-gauge subspace: the dense solver's solution. With a mesh the
    edge shards' sums are all-reduced: once for (g, D, cost), then once a
    Hessian application."""
    M = states.shape[0]
    r, Ji, Jj, iw, jw = _linearize(states, ei, ej, z, w)
    JiT, JjT = Ji.transpose(1, 2), Jj.transpose(1, 2)

    def jt_apply(u):  # this shard's J^T u: (K, 6) -> (M, 6)
        g = states.new_zeros((M, 6))
        _scatter(g, (iw,), (JiT @ u[:, :, None])[..., 0])
        return _scatter(g, (jw,), (JjT @ u[:, :, None])[..., 0])

    D = states.new_zeros((M, 6, 6))
    _scatter(D, (iw,), JiT @ Ji)
    _scatter(D, (jw,), JjT @ Jj)
    g, D, cost = psum(mesh, (jt_apply(r), D, torch.sum(r * r)))
    eye = torch.eye(6, dtype=states.dtype, device=states.device)
    D = D + damping * eye
    if fixed_first:
        g[0] = 0.0
        D[0] = eye
    Pinv = torch.linalg.inv(D)

    def precond(v):
        return (Pinv @ v[:, :, None])[..., 0]

    def hess_apply(v):  # (J^T J + damping I) v, the gauge row pinned
        u = (Ji @ v[iw][:, :, None])[..., 0] + (Jj @ v[jw][:, :, None])[..., 0]
        y = psum(mesh, jt_apply(u)) + damping * v
        if fixed_first:
            y[0] = v[0]
        return y

    gnorm = torch.sum(g * g)
    x = torch.zeros_like(g)
    rv, p = g, precond(g)
    rz = torch.sum(rv * p)
    for _ in range(cg_iterations):
        if not bool((rz > 0.0) & (torch.sum(rv * rv) > (cg_tol * cg_tol) * gnorm)):
            break
        Hp = hess_apply(p)
        pHp = torch.sum(p * Hp)
        alpha = torch.where(pHp > 0.0, rz / torch.where(pHp > 0.0, pHp, 1.0), 0.0)
        x = x + alpha * p
        rv = rv - alpha * Hp
        zv = precond(rv)
        rz_new = torch.sum(rv * zv)
        p = zv + rz_new / torch.where(rz > 0.0, rz, 1.0) * p
        rz = rz_new
    step = torch.where(torch.isfinite(x).all(), x, torch.zeros_like(x))
    return states - step, cost


def _pad(x, n, value):
    return torch.cat([x, torch.full((n, *x.shape[1:]), value, dtype=x.dtype, device=x.device)])


def optimize_pose_graph(
    graph: PoseGraph,
    mesh=None,
    iterations: int = 10,
    damping: float = 1e-6,
    fixed_first: bool = True,
    solver: str = "auto",
    cg_iterations: int = 100,
    cg_tol: float = 1e-8,
    bucket: bool = False,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton over all keyframe poses, in float32 on `device`. With
    device None it is the graph's own device when its arrays are tensors,
    else the CUDA card, as for the object APIs: where torch finds no card
    that raises RuntimeError, and device="cpu" solves on the CPU. Returns
    (states (M, 6), the cost at the last linearization).

    solver: 'dense' forms the block Hessian and solves the (6M, 6M)
    system; 'cg' never forms it (memory and work O(M + K) a CG iteration);
    'auto' is 'dense' for M <= 192, else 'cg', as in phovo_tpu.

    bucket pads the pose count and the edge count to powers of two (floor
    32 and 64) as phovo_tpu does to reuse compiled programs. Eager torch
    compiles nothing, so here it only keeps the signature: padding poses
    have no edges (their rows are damping-only, their step exactly 0) and
    padding edges carry i = -1, so the states returned (sliced to M) are
    those of the unpadded solve up to float32 rounding in the dense solve.

    mesh (parallel/mesh.py): every rank of the mesh calls with the same
    graph; the (bucketed) edges are split over its ranks, flattened, each
    rank's blocks summed over the mesh, and every rank returns the same
    states. A one-rank mesh gives the unsharded bits."""
    if solver == "auto":
        solver = "dense" if graph.states.shape[0] <= 192 else "cg"
    if solver not in ("dense", "cg"):
        raise ValueError(f"unknown solver {solver!r}")
    if device is None:
        device = graph.states.device if isinstance(graph.states, torch.Tensor) else DEFAULT_DEVICE
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "optimize_pose_graph runs on the CUDA card by default and torch "
            "finds none; pass device=\"cpu\" to solve on the CPU"
        )

    def tensor(x, dtype):
        return (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))).to(device, dtype)

    states = tensor(graph.states, torch.float32)
    ei, ej = tensor(graph.edges_i, torch.int64), tensor(graph.edges_j, torch.int64)
    z, w = tensor(graph.measurements, torch.float32), tensor(graph.weights, torch.float32)
    M, K = states.shape[0], ei.shape[0]
    if bucket:
        Mb = max(32, 1 << (M - 1).bit_length())
        Kb = max(64, 1 << (K - 1).bit_length()) if K else 64
        states = _pad(states, Mb - M, 0.0)
        ei, ej = _pad(ei, Kb - K, -1), _pad(ej, Kb - K, -1)
        z, w = _pad(z, Kb - K, 0.0), _pad(w, Kb - K, 0.0)
    if mesh is not None and mesh.size > 1:
        lo, hi = shard_bounds(ei.shape[0], mesh.size, mesh.flat_index)
        ei, ej, z, w = ei[lo:hi], ej[lo:hi], z[lo:hi], w[lo:hi]
    cost = states.new_zeros(())
    for _ in range(iterations):
        if solver == "dense":
            states, cost = _dense_gn_step(states, ei, ej, z, w, damping, fixed_first, mesh)
        else:
            states, cost = _cg_gn_step(states, ei, ej, z, w, damping, fixed_first, cg_iterations, cg_tol, mesh)
    return states[:M], cost


def chain_to_graph(
    relative_states: torch.Tensor,  # (N-1, 6) front-end per-pair states
    loop_closures=None,  # [(i, j, z (6,))]
    odometry_weight: float = 1.0,
    loop_weight: float = 1.0,
) -> PoseGraph:
    """A pose graph from sequential odometry and optional loop edges. The
    front end's align(source=k, target=k+1) estimates T with p_{k+1} = T
    p_k and the trajectory integrates pose_{k+1} = pose_k @ T^{-1}
    (PhotoconsistencyVisualOdometry.cpp:233-234), so edge (k, k+1)
    measures T^{-1}; the initial states are the integrated poses."""
    rel = torch.as_tensor(relative_states, dtype=torch.float32)
    N = rel.shape[0] + 1
    meas = se3.matrix_to_state(se3.inverse(se3.pose_matrix(rel)))
    states = torch.cat([rel.new_zeros((1, 6)), se3.matrix_to_state(se3.integrate_trajectory(rel))])
    ei, ej = list(range(N - 1)), list(range(1, N))
    zs, ws = list(meas), [odometry_weight] * (N - 1)
    for i, j, z in loop_closures or []:
        ei.append(i)
        ej.append(j)
        zs.append(torch.as_tensor(z, dtype=torch.float32, device=rel.device))
        ws.append(loop_weight)
    return PoseGraph(
        states=states,
        edges_i=torch.tensor(ei, dtype=torch.int64, device=rel.device),
        edges_j=torch.tensor(ej, dtype=torch.int64, device=rel.device),
        measurements=torch.stack(zs),
        weights=torch.tensor(ws, dtype=torch.float32, device=rel.device),
    )
