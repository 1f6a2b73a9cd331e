"""RGB-D bundle adjustment with Schur-complement elimination (torch port
of phovo_tpu/parallel/bundle_adjustment.py, single device).

M keyframe poses and P world landmarks are refined jointly against pixel
and depth observations. With per-observation residual r_k(s_i, X_j) and
Jacobians A_k = dr/ds_i (3x6), B_k = dr/dX_j (3x3), the Gauss-Newton
system is

    [ U   W ] [dx_pose ]   [ v ]        U: block-diag (M, 6, 6)
    [ W^T V ] [dx_point] = [ w ]        V: block-diag (P, 3, 3)

and the landmarks are eliminated by the Schur complement

    S = U - W V^{-1} W^T          (the 6M x 6M reduced camera system)
    S dx_pose = v - W V^{-1} w
    dx_point_j = V_j^{-1} (w_j - sum_i W_{ij}^T dx_pose_i)

W is either dense, (M, P, 6, 3), or never formed: the sparse path adds
the off-diagonal Schur blocks over the list of observation pairs that
share a landmark (build_schur_pairs). A monotone Levenberg-Marquardt
loop (_lm_iterate) steps from the best accepted iterate.

phovo_tpu runs this as XLA code (vmapped jax.jacfwd, scatter-adds,
einsums, jnp.linalg), with no Pallas kernel, and so does the port: plain
torch on the device the caller names. The per-observation Jacobians are
forward-mode derivatives of the batched residual (torch.func.jvp over the
nine tangent directions, the jacfwd of phovo_tpu); the blocks are summed
in a fixed order (scatter_add), so two runs give the same bits; the solves
are torch.linalg's *_ex forms, which neither raise nor read the device's
status back, and the LM accept/reject is torch.where on device tensors.

Conventions: the pose state s_i is [x y z yaw pitch roll] with T_i =
pose_matrix(s_i) world-from-keyframe, landmarks are in world coordinates,
and a landmark is observed at pixel (u, v) through the reference's
pinhole projection (u = fx x / z + cx).

With a mesh (parallel/mesh.py) the observations are sharded over all its
ranks, flattened: each rank linearizes its observations and ONE
all_reduce a build, so one an LM iteration, merges the blocks {U, V, W,
v, w, cost} (merge_blocks; the sparse path's per-observation AtB rows are
gathered in the same collective); every rank then solves the same reduced
camera system. Sums over ranks round in the backend's order, so a sharded
run agrees with the unsharded one to float32 rounding, and two runs at
one world size give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from phovo_tpu_torch.models.base import DEFAULT_DEVICE
from phovo_tpu_torch.ops import se3
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.parallel.mesh import psum, shard_bounds

# schur='auto' memory guard, shared with parallel/photometric_ba.py: the
# dense path holds W (M, P, 6, 3) and the W V^-1 intermediate of the same
# size, 2 * M * P * 18 float32 values; above the budget 'auto' takes the
# sparse path. phovo_tpu's value, so that both packages route alike.
DENSE_W_BUDGET_BYTES = 256e6


def dense_w_fits(n_poses: int, n_points: int) -> bool:
    """True when the dense-Schur W intermediates of an (M poses, P points)
    problem fit DENSE_W_BUDGET_BYTES."""
    return 2 * n_poses * n_points * 18 * 4 <= DENSE_W_BUDGET_BYTES


class BAProblem(NamedTuple):
    """An RGB-D bundle-adjustment problem (numpy arrays or tensors).

    An observation is a pixel (u, v) and the measured camera-frame depth z:
    without the depth rows global scale is a gauge freedom. z_weights 0
    makes an observation pixel-only. Observations with pose index -1 are
    padding and contribute exact zeros; a landmark no observation sees is
    frozen by the V damping floor."""

    pose_states: torch.Tensor  # (M, 6) keyframe states (world <- keyframe)
    points: torch.Tensor  # (P, 3) world landmarks
    obs_pose: torch.Tensor  # (K,) keyframe index per observation (-1 pad)
    obs_point: torch.Tensor  # (K,) landmark index per observation
    obs_uv: torch.Tensor  # (K, 2) measured pixel (u, v)
    obs_z: torch.Tensor  # (K,) measured camera-frame depth (metres)
    weights: torch.Tensor  # (K,) pixel information weight
    z_weights: torch.Tensor  # (K,) depth information weight (0 = pixel-only)


def resolve_device(device, like=None) -> torch.device:
    """The device to run on: `device` if given, else `like`'s device where
    it is a tensor, else the CUDA card; a card that torch cannot find
    raises RuntimeError (device="cpu" runs on the CPU)."""
    if device is None:
        device = like.device if isinstance(like, torch.Tensor) else DEFAULT_DEVICE
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the bundle adjustment runs on the CUDA card by default and torch "
            "finds none; pass device=\"cpu\" to run on the CPU"
        )
    return device


def to_tensor(x, device, dtype) -> torch.Tensor:
    return (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))).to(device, dtype)


def observation_shard(mesh, n_obs: int) -> tuple[int, int]:
    """[start, stop) of this rank's observations of n_obs: all of them
    without a mesh or on one rank, else its slice over the flattened
    mesh."""
    if mesh is None or mesh.size == 1:
        return 0, n_obs
    return shard_bounds(n_obs, mesh.size, mesh.flat_index)


def merge_blocks(mesh, blocks, sparse: bool, n_obs: int, lo: int):
    """A shard's blocks summed over the mesh in ONE all_reduce: U, V, the
    dense W, v, w and the cost added; the sparse path's per-observation
    AtB placed at rows [lo, lo + shard) of a zero-filled (n_obs, 6, 3), so
    every rank holds every row. The blocks themselves without a mesh or on
    one rank."""
    if mesh is None or mesh.size == 1:
        return blocks  # psum would return them too; the sparse AtB needs no gather
    U, V, W, vv, ww, cost = blocks
    if sparse:
        full = W.new_zeros((n_obs, *W.shape[1:]))
        full[lo:lo + W.shape[0]] = W
        W = full
    return psum(mesh, (U, V, W, vv, ww, cost))


def camera_point(states: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(..., 6) world<-camera states, (..., 3) world points -> (..., 3)
    camera-frame points R^T (X - t)."""
    T = se3.pose_matrix(states)
    R = T[..., :3, :3]
    d = points - T[..., :3, 3]
    return R[..., 0, :] * d[..., 0:1] + R[..., 1, :] * d[..., 1:2] + R[..., 2, :] * d[..., 2:3]


def pixel(p: torch.Tensor, intr: Intrinsics):
    """Camera-frame points (..., 3) -> (u, v, z), the depth guarded away
    from 0 in the division (phovo_tpu's safe_z)."""
    z = p[..., 2]
    safe_z = torch.where(z.abs() > 1e-12, z, torch.full_like(z, 1e-12))
    return intr.fx * p[..., 0] / safe_z + intr.cx, intr.fy * p[..., 1] / safe_z + intr.cy, z


def project_point(state: torch.Tensor, point: torch.Tensor, intr: Intrinsics):
    """Project world points into the keyframes with poses `state` (any
    matching leading dims). Returns ((..., 2) pixel (u, v), (...) depth in
    the camera)."""
    u, v, z = pixel(camera_point(state, point), intr)
    return torch.stack([u, v], dim=-1), z


def _obs_residual(states, points, uvz, intr):
    """(K, 3): predicted minus measured (u, v, z) of each observation."""
    u, v, z = pixel(camera_point(states, points), intr)
    return torch.stack([u - uvz[:, 0], v - uvz[:, 1], z - uvz[:, 2]], dim=-1)


def observation_jacobians(fn, states: torch.Tensor, points: torch.Tensor, has_aux: bool = False):
    """fn(states (K, 6), points (K, 3)) -> residual rows (K, a) [, aux],
    each row a function of its own observation's state and point only.
    Returns (r (K, a), A = dr/ds (K, a, 6), B = dr/dX (K, a, 3)[, aux]):
    forward mode along the nine tangent directions, each applied to every
    observation at once (torch.func.jvp vmapped over the directions; the
    vmapped per-observation jax.jacfwd of phovo_tpu)."""
    K = states.shape[0]
    eye = torch.eye(9, dtype=states.dtype, device=states.device)
    t_s = eye[:, None, :6].expand(9, K, 6)
    t_x = eye[:, None, 6:].expand(9, K, 3)

    def push(ts, tx):
        return torch.func.jvp(fn, (states, points), (ts, tx), has_aux=has_aux)

    out = torch.func.vmap(push)(t_s, t_x)
    r, J = out[0][0], out[1].permute(1, 2, 0)  # (K, a, 9)
    if has_aux:
        return r, J[..., :6], J[..., 6:], out[2][0]
    return r, J[..., :6], J[..., 6:]


def _linearize_obs(states, points, obs_pose, obs_point, obs_uv, obs_z, weights, z_weights, intr):
    """Per-observation residuals r (K, 3) and Jacobians A (K, 3, 6), B (K,
    3, 3): rows 0-1 the pixel residual scaled by sqrt(w), row 2 the depth
    residual scaled by sqrt(w_z), all rows zeroed on padding. Also the
    gather indices iw, jw (K,)."""
    valid = obs_pose >= 0
    iw = torch.where(valid, obs_pose, 0).long()
    jw = torch.where(valid, obs_point, 0).long()
    uvz = torch.cat([obs_uv, obs_z[:, None]], dim=1)
    r, A, B = observation_jacobians(lambda s, X: _obs_residual(s, X, uvz, intr), states[iw], points[jw])
    vf = valid.to(r.dtype)
    sq = torch.sqrt(weights) * vf
    sw = torch.stack([sq, sq, torch.sqrt(z_weights) * vf], dim=1)
    return r * sw, A * sw[:, :, None], B * sw[:, :, None], iw, jw


def huber_scale(x: torch.Tensor, delta: float) -> torch.Tensor:
    """sqrt(min(1, delta / max(x, 1e-12))): the Huber IRLS row scale
    (a true division, as phovo_tpu's; torch takes a Python number over a
    tensor as a reciprocal and a product)."""
    return torch.sqrt(torch.clamp(x.new_tensor(delta) / torch.clamp(x, min=1e-12), max=1.0))


def scatter_add(out: torch.Tensor, index: tuple, values: torch.Tensor) -> torch.Tensor:
    """out[index[0][k], ...] += values[k] for every k (duplicates add up),
    in a fixed order, so that two runs give the same bits: index_put_ with
    accumulate on the card (its CUDA form sorts the indices and adds each
    segment in order), index_add_ over the flattened leading dims on the
    CPU (serial; the CPU index_put_ adds large scatters in parallel with
    atomics)."""
    if out.device.type != "cpu":
        return out.index_put_(index, values, accumulate=True)
    lin = index[0]
    for dim, idx in zip(out.shape[1:len(index)], index[1:]):
        lin = lin * dim + idx
    out.view(-1, *out.shape[len(index):]).index_add_(0, lin, values)
    return out


def normal_blocks(r, A, B, iw, jw, M: int, Pn: int, sparse: bool):
    """The merged blocks {U, V, W | AtB, v, w, cost} of weighted rows: the
    per-observation products summed into their keyframe and landmark
    blocks (scatter_add). sparse returns the
    per-observation coupling blocks AtB (K, 6, 3) in place of the dense W
    (the _schur_step_sparse contract)."""
    At, Bt = A.transpose(1, 2), B.transpose(1, 2)
    AtB = At @ B  # (K, 6, 3)
    Atr = (At @ r[:, :, None])[..., 0]
    Btr = (Bt @ r[:, :, None])[..., 0]
    z = r.new_zeros
    U = scatter_add(z((M, 6, 6)), (iw,), At @ A)
    V = scatter_add(z((Pn, 3, 3)), (jw,), Bt @ B)
    vv = scatter_add(z((M, 6)), (iw,), Atr)
    ww = scatter_add(z((Pn, 3)), (jw,), Btr)
    cost = torch.sum(r * r)
    if sparse:
        return U, V, AtB, vv, ww, cost
    return U, V, scatter_add(z((M, Pn, 6, 3)), (iw, jw), AtB), vv, ww, cost


def _accumulate(states, points, problem: BAProblem, intr, M: int, Pn: int, robust_delta=None, sparse=False):
    """The blocks of one linearization at (states, points)."""
    r, A, B, iw, jw = _linearize_obs(states, points, problem.obs_pose, problem.obs_point, problem.obs_uv,
                                     problem.obs_z, problem.weights, problem.z_weights, intr)
    if robust_delta is not None:
        # Huber IRLS on each observation's whitened residual norm
        sw = huber_scale(torch.sqrt(torch.sum(r * r, dim=1)), robust_delta)
        r, A, B = r * sw[:, None], A * sw[:, None, None], B * sw[:, None, None]
    return normal_blocks(r, A, B, iw, jw, M, Pn, sparse)


def _damped_vinv(V: torch.Tensor, damping) -> torch.Tensor:
    """Inverse of the damped landmark blocks, multiplicative
    (Levenberg-Marquardt) damping of the diagonal. An unobserved landmark
    gets the identity, so its update is exactly zero; the absolute 1e-10
    floor keeps a block with an exactly zero diagonal entry (a point on
    the optical axis seen pixel-only) invertible."""
    eye = torch.eye(3, dtype=V.dtype, device=V.device)
    empty = (V.abs().sum((-1, -2), keepdim=True) == 0).to(V.dtype)
    return torch.linalg.inv_ex(V + damping * (V * eye) + (empty + 1e-10) * eye)[0]


def _reduced_pose_solve(U, S, rhs, damping, fixed_first: bool) -> torch.Tensor:
    """Solve the Schur-reduced camera system S dx = rhs (S has U on its
    block diagonal): the gauge (pose 0) pinned, the multiplicative ridge on
    U's diagonal plus an absolute 1e-10 floor, and symmetric Jacobi
    rescaling (the raw system mixes metre and radian columns, cond ~1e12,
    past what a float32 solve takes)."""
    M = U.shape[0]
    Sd = S.permute(0, 2, 1, 3).reshape(6 * M, 6 * M)
    gd = rhs.reshape(6 * M)
    if fixed_first:
        mask = torch.ones(6 * M, dtype=S.dtype, device=S.device)
        mask[:6] = 0.0
        Sd = Sd * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
        gd = gd * mask
    U_diag = torch.diagonal(U, dim1=-2, dim2=-1).reshape(6 * M)
    Sd = Sd + torch.diag(damping * U_diag + 1e-10)
    d = torch.sqrt(torch.clamp(torch.diagonal(Sd), min=1e-12))
    Ss = Sd / d[:, None] / d[None, :]
    return (torch.linalg.solve_ex(Ss, gd / d)[0] / d).reshape(M, 6)


def _finite_update(states, points, dx_pose, dx_point, cost):
    """The update applied, or no update at all where any entry is not
    finite."""
    finite = torch.isfinite(dx_pose).all() & torch.isfinite(dx_point).all()
    dx_pose = torch.where(finite, dx_pose, torch.zeros_like(dx_pose))
    dx_point = torch.where(finite, dx_point, torch.zeros_like(dx_point))
    return states - dx_pose, points - dx_point, cost


def _schur_step(states, points, blocks, damping, fixed_first: bool):
    """One GN update from merged blocks with a dense W: Schur-reduce,
    solve, back-substitute."""
    U, V, Wb, vv, ww, cost = blocks
    M = U.shape[0]
    Vinv = _damped_vinv(V, damping)
    WVinv = torch.einsum("ipab,pbc->ipac", Wb, Vinv)  # (M, P, 6, 3)
    S = -torch.einsum("ipac,jpdc->ijad", WVinv, Wb)  # (M, M, 6, 6)
    ar = torch.arange(M, device=U.device)
    S[ar, ar] += U
    rhs = vv - torch.einsum("ipac,pc->ia", WVinv, ww)
    dx_pose = _reduced_pose_solve(U, S, rhs, damping, fixed_first)
    corr = torch.einsum("ipab,ia->pb", Wb, dx_pose)  # (P, 3)
    dx_point = torch.einsum("pab,pb->pa", Vinv, ww - corr)
    return _finite_update(states, points, dx_pose, dx_point, cost)


def build_schur_pairs(obs_pose, obs_point):
    """Host-side sparse Schur fill pattern: int32 (pair_a, pair_b) arrays of
    every ORDERED pair of real observations that share a landmark (the
    camera-block pairs the term sum_j W_{i_a j} Vinv_j W_{i_b j}^T touches),
    landmark by landmark in increasing index, each landmark's pairs in
    row-major order of its observations (phovo_tpu's order). Size
    sum_j n_j^2 (n_j: observations of landmark j), unpadded; with no real
    observation, one -1 row (no pair)."""
    op = np.asarray(obs_pose)
    ol = np.asarray(obs_point)
    real = np.nonzero(op >= 0)[0]
    if not len(real):
        return -np.ones(1, np.int32), -np.ones(1, np.int32)
    order = real[np.argsort(ol[real], kind="stable")]
    _, start, count = np.unique(ol[order], return_index=True, return_counts=True)
    n = np.repeat(count, count)  # each observation's landmark's count
    first = np.repeat(start, count)  # and the landmark's first position
    pa = np.repeat(order, n).astype(np.int32)
    # pair q of position k (its landmark's q-th observation)
    offsets = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    pb = order[np.repeat(first, n) + offsets].astype(np.int32)
    return pa, pb


def _schur_step_sparse(states, points, blocks, damping, fixed_first: bool, *, pair_a, pair_b):
    """Sparse-W GN update: the (M, P, 6, 3) W is never formed. blocks holds
    the per-observation coupling blocks AtB (K, 6, 3) and their (iw, jw)
    indices; the W contractions become scatter-adds:

      S_off[i_a, i_b] += AtB_a Vinv_j AtB_b^T   over the pair list
      rhs[i]          -= AtB_k Vinv_{j_k} w_{j_k}  per observation
      corr[j]         += AtB_k^T dx_pose[i_k]      per observation

    Memory O(K + sum_j n_j^2) instead of O(M P). pair_a, pair_b (device
    int64, from build_schur_pairs) index the pair list."""
    U, V, AtB, iw, jw, vv, ww, cost = blocks
    M = U.shape[0]
    Vinv = _damped_vinv(V, damping)
    WV = AtB @ Vinv[jw]  # (K, 6, 3)
    maskp = (pair_a >= 0).to(U.dtype)
    pa = torch.where(pair_a >= 0, pair_a, 0)
    pb = torch.where(pair_b >= 0, pair_b, 0)
    Sblk = (WV[pa] @ AtB[pb].transpose(1, 2)) * maskp[:, None, None]  # (K2, 6, 6)
    S = scatter_add(U.new_zeros((M, M, 6, 6)), (iw[pa], iw[pb]), -Sblk)
    ar = torch.arange(M, device=U.device)
    S[ar, ar] += U
    rhs = vv - scatter_add(U.new_zeros((M, 6)), (iw,), (WV @ ww[jw][:, :, None])[..., 0])
    dx_pose = _reduced_pose_solve(U, S, rhs, damping, fixed_first)
    corr = scatter_add(torch.zeros_like(ww), (jw,), (AtB.transpose(1, 2) @ dx_pose[iw][:, :, None])[..., 0])
    dx_point = (Vinv @ (ww - corr)[:, :, None])[..., 0]
    return _finite_update(states, points, dx_pose, dx_point, cost)


def _lm_iterate(build, states0, points0, iterations: int, damping, fixed_first: bool, step_fn=_schur_step):
    """Monotone Levenberg-Marquardt over step_fn. Each iteration steps FROM
    the best accepted iterate with its CACHED blocks and builds the trial
    point once: a trial with cost <= the best cost (exactly; plateaus keep
    moving) becomes the best and halves the ridge (floored at `damping`);
    a rejected one multiplies it by 8 (capped at 1e3) and its blocks are
    dropped, so a rejection never re-linearizes. The decisions are
    torch.where on device tensors: no value is read back to the host.
    Returns (best states, best points, best cost), the cost never
    increasing; iterations + 1 builds."""
    blocks = build(states0, points0)
    floor = blocks[-1].new_tensor(damping)
    best_s, best_p, best_cost, lam = states0, points0, blocks[-1], floor
    for _ in range(iterations):
        st_s, st_p, _ = step_fn(best_s, best_p, blocks, lam, fixed_first)
        trial = build(st_s, st_p)
        cost = trial[-1]
        ok = cost <= best_cost
        best_s = torch.where(ok, st_s, best_s)
        best_p = torch.where(ok, st_p, best_p)
        blocks = tuple(torch.where(ok, a, b) for a, b in zip(trial, blocks))
        best_cost = torch.minimum(cost, best_cost)
        lam = torch.where(ok, torch.maximum(lam * 0.5, floor), torch.clamp(lam * 8.0, max=1e3))
    return best_s, best_p, best_cost


def sparse_build(raw_build, obs_pose, obs_point):
    """raw_build's blocks with the observations' (iw, jw) inserted, as
    _schur_step_sparse takes them."""
    valid = obs_pose >= 0
    iw = torch.where(valid, obs_pose, 0).long()
    jw = torch.where(valid, obs_point, 0).long()

    def build(states, points):
        U, V, AtB, vv, ww, cost = raw_build(states, points)
        return U, V, AtB, iw, jw, vv, ww, cost

    return build


def schur_route(schur: str, M: int, Pn: int) -> str:
    """'dense' or 'sparse' for a schur option ('auto': dense where W fits
    DENSE_W_BUDGET_BYTES)."""
    if schur not in ("dense", "sparse", "auto"):
        raise ValueError(f"schur={schur!r}; expected 'dense', 'sparse', or 'auto'")
    if schur == "auto":
        return "dense" if dense_w_fits(M, Pn) else "sparse"
    return schur


def pair_tensors(obs_pose, obs_point, device):
    """build_schur_pairs of the observations, on `device` (int64)."""
    pa, pb = build_schur_pairs(obs_pose.cpu().numpy(), obs_point.cpu().numpy())
    return torch.from_numpy(pa).to(device, torch.int64), torch.from_numpy(pb).to(device, torch.int64)


def optimize_bundle(
    problem: BAProblem,
    intr: Intrinsics,
    mesh=None,
    iterations: int = 10,
    damping: float = 1e-6,
    fixed_first: bool = True,
    robust_delta: float | None = None,
    schur: str = "dense",
    device=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Levenberg-Marquardt bundle adjustment in float32 on `device` (the
    problem's when its states are a tensor, else the CUDA card; a missing
    card raises RuntimeError, device="cpu" runs on the CPU). Returns
    (pose_states, points, cost).

    robust_delta: Huber IRLS weight on each observation's whitened residual
    norm (pixel-equivalents). schur: 'dense' forms W (M, P, 6, 3); 'sparse'
    never does and adds the Schur fill over the same-landmark pair list,
    memory O(K x mean track length); 'auto' is dense where W and W V^-1
    fit DENSE_W_BUDGET_BYTES, else sparse. mesh (parallel/mesh.py): every
    rank calls with the same problem, its observations are split over the
    mesh's ranks and the blocks merged once an iteration (merge_blocks);
    every rank returns the same result, a one-rank mesh the unsharded
    bits."""
    dev = resolve_device(device, problem.pose_states)
    route = schur_route(schur, int(problem.pose_states.shape[0]), int(problem.points.shape[0]))
    f32, i64 = torch.float32, torch.int64
    problem = BAProblem(*(to_tensor(x, dev, i64 if k in (2, 3) else f32) for k, x in enumerate(problem)))
    pair_a = pair_b = None
    if route == "sparse":
        pair_a, pair_b = pair_tensors(problem.obs_pose, problem.obs_point, dev)
    return _optimize_bundle_core(problem, intr, damping, pair_a, pair_b, iterations=iterations,
                                 fixed_first=fixed_first, robust_delta=robust_delta, mesh=mesh)


def _optimize_bundle_core(problem, intr, damping, pair_a, pair_b, *, iterations, fixed_first, robust_delta,
                          mesh=None):
    """The LM loop over a problem on its device; pair_a not None selects
    the sparse-W path; mesh shards the observations."""
    M, Pn, K = problem.pose_states.shape[0], problem.points.shape[0], problem.obs_pose.shape[0]
    sparse = pair_a is not None
    lo, hi = observation_shard(mesh, K)
    shard = problem._replace(**{f: getattr(problem, f)[lo:hi] for f in BAProblem._fields[2:]})

    def raw_build(states, points):
        blocks = _accumulate(states, points, shard, intr, M, Pn, robust_delta, sparse)
        return merge_blocks(mesh, blocks, sparse, K, lo)

    if sparse:
        build = sparse_build(raw_build, problem.obs_pose, problem.obs_point)

        def step_fn(*a):
            return _schur_step_sparse(*a, pair_a=pair_a, pair_b=pair_b)
    else:
        build, step_fn = raw_build, _schur_step
    return _lm_iterate(build, problem.pose_states, problem.points, iterations, damping, fixed_first, step_fn)


def dense_gn_step(problem: BAProblem, intr: Intrinsics, damping: float = 1e-6, fixed_first: bool = True):
    """One GN update solving the FULL (6M + 3P) system in numpy float64:
    the oracle the Schur elimination is tested against (the raw system's
    cond ~1e12 would make a float32 oracle noisier than the path it
    checks). Runs the linearization on the problem's device (the CPU for
    numpy arrays)."""
    dev = problem.pose_states.device if isinstance(problem.pose_states, torch.Tensor) else torch.device("cpu")
    p = BAProblem(*(to_tensor(x, dev, torch.int64 if k in (2, 3) else torch.float32) for k, x in enumerate(problem)))
    M, Pn = p.pose_states.shape[0], p.points.shape[0]
    r, A, B, iw, jw = _linearize_obs(p.pose_states, p.points, p.obs_pose, p.obs_point, p.obs_uv, p.obs_z,
                                     p.weights, p.z_weights, intr)
    r, A, B, iw, jw = (x.cpu().numpy() for x in (r, A, B, iw, jw))
    r, A, B = (x.astype(np.float64) for x in (r, A, B))
    K, a = r.shape
    D = 6 * M + 3 * Pn
    J = np.zeros((K, a, D), np.float64)
    for k in range(K):
        J[k, :, 6 * iw[k]:6 * iw[k] + 6] = A[k]
        J[k, :, 6 * M + 3 * jw[k]:6 * M + 3 * jw[k] + 3] = B[k]
    Jf, rf = J.reshape(K * a, D), r.reshape(K * a)
    H, g = Jf.T @ Jf, Jf.T @ rf
    if fixed_first:
        mask = np.concatenate([np.zeros(6), np.ones(D - 6)])
        H = H * mask[:, None] * mask[None, :] + np.diag(1.0 - mask)
        g = g * mask
    H = H + np.diag(damping * np.diag(H) + 1e-10)
    for q in range(Pn):  # the identity floor of unobserved landmarks
        blk = slice(6 * M + 3 * q, 6 * M + 3 * q + 3)
        if np.abs(H[blk, blk]).sum() < 1e-8:
            H[blk, blk] += np.eye(3)
    dx = np.linalg.solve(H, g)
    states = p.pose_states - torch.from_numpy(dx[:6 * M].reshape(M, 6).astype(np.float32)).to(dev)
    points = p.points - torch.from_numpy(dx[6 * M:].reshape(Pn, 3).astype(np.float32)).to(dev)
    return states, points, float(np.sum(r * r))


def make_synthetic_ba(
    n_poses: int = 6,
    n_points: int = 64,
    intr: Intrinsics | None = None,
    obs_per_pose: int | None = None,
    pixel_noise: float = 0.0,
    depth_noise: float = 0.0,
    state_noise: float = 0.02,
    point_noise: float = 0.02,
    seed: int = 0,
):
    """A ground-truthed synthetic RGB-D problem: poses on a short arc
    looking at a landmark cloud, every pose observing every landmark, or
    obs_per_pose distinct landmarks a pose. Depth rows carry the (fx/z)^2
    information weight (pixel-equivalent units). The random draws are
    phovo_tpu's, in its order; the projections run in float32 on the CPU.
    Returns (problem of numpy arrays, gt_states, gt_points)."""
    if intr is None:
        from phovo_tpu_torch.ops.camera import TUM_DEFAULT

        intr = TUM_DEFAULT
    rng = np.random.default_rng(seed)
    gt_states = np.zeros((n_poses, 6), np.float32)
    gt_states[:, 0] = np.linspace(0.0, 0.4, n_poses)  # translate in x
    gt_states[:, 3] = np.linspace(0.0, 0.05, n_poses)  # slight yaw
    pts = np.stack([rng.uniform(-1.0, 1.0, n_points), rng.uniform(-0.8, 0.8, n_points),
                    rng.uniform(2.0, 4.0, n_points)], axis=1).astype(np.float32)
    X = torch.from_numpy(pts)
    obs_pose, obs_point, obs_uv, obs_z, z_w = [], [], [], [], []
    fx = np.float32(intr.fx)
    for i in range(n_poses):
        uv, z = project_point(torch.from_numpy(gt_states[i]).expand(n_points, 6), X, intr)
        uv = uv.numpy() + rng.normal(0.0, pixel_noise, (n_points, 2)).astype(np.float32)
        z = z.numpy() + rng.normal(0.0, depth_noise, n_points).astype(np.float32)
        sel = np.arange(n_points) if obs_per_pose is None else rng.choice(n_points, obs_per_pose, replace=False)
        obs_pose.append(np.full(len(sel), i, np.int32))
        obs_point.append(sel.astype(np.int32))
        obs_uv.append(uv[sel])
        obs_z.append(z[sel])
        # phovo_tpu's float32 expression: (fx / max(z, 0.1)) ** 2
        z_w.append((fx / np.maximum(z[sel], np.float32(0.1))) ** 2)
    init_states = gt_states + rng.normal(0.0, state_noise, gt_states.shape).astype(np.float32)
    init_states[0] = gt_states[0]  # gauge anchor
    init_points = pts + rng.normal(0.0, point_noise, pts.shape).astype(np.float32)
    problem = BAProblem(
        pose_states=init_states,
        points=init_points,
        obs_pose=np.concatenate(obs_pose),
        obs_point=np.concatenate(obs_point),
        obs_uv=np.concatenate(obs_uv).astype(np.float32),
        obs_z=np.concatenate(obs_z).astype(np.float32),
        weights=np.ones(sum(len(o) for o in obs_pose), np.float32),
        z_weights=np.concatenate(z_w).astype(np.float32),
    )
    return problem, gt_states, pts
