"""Inverse-compositional Gauss-Newton (torch port of phovo_tpu/ops/ic.py):
the constant per-level Jacobian system and the level loop.

The inverse-compositional (IC) formulation (Baker & Matthews, "Lucas-Kanade
20 Years On") parametrizes the update on the SOURCE frame,

    min_delta  sum_k [ I1(pi(T x) p_k) - I0(pi(T(delta) p_k)) ]^2,

so the Jacobian J0_k = grad I0(p_k) . dpi/dp . dT/ddelta|0 depends only on
the source frame: J0, J0^T J0 and its Cholesky factor come once per pyramid
level, and every iteration warps, samples ONE target channel, forms
g = J0^T r, solves against the frozen factor and composes
T <- T . T(lambda delta)^-1, with the pose held as a rotation matrix and a
translation.

Two routes, as phovo_tpu has:
  * the exact one (ic_precompute, ic_gn_level_exact): torch.linalg's
    Cholesky factor and solve, the 4x4 pose through se3.pose_matrix and
    se3.inverse; the counterpart of phovo_tpu's XLA form;
  * the kernel route: ic_precompute_batch launches csrc/ic_precompute.cu
    (K-ICpre, one thread-block cluster of ic_precompute_cluster_size(H, W)
    blocks per frame) on CUDA tensors, and ic_gn_level
    runs the level kernel csrc/ic_gn_batch.cu (K-IC, ops/ic_batch.py) at
    B = 1. On CPU tensors each runs its plain torch version, written over
    (B,) tensors in the TPU kernels' expression order (_chol_factor,
    _tri_solve, _compose_inverse_update here).

Approximation (standard for IC trackers, and phovo_tpu's): J0^T J0 sums all
depth-valid source pixels; a pixel whose warp leaves the target in an
iteration contributes r = 0 but stays in the factored system.
"""

from __future__ import annotations

import torch

from phovo_tpu_torch.ops import se3
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.residuals import warp_and_jacobian
from phovo_tpu_torch.ops.warp import sample_bilinear, sample_nearest

# Launches of K-ICpre in this process. The wrapper adds one per launch and
# nowhere else, so a caller can show that its run went through the kernel
# (reset it to 0 before the run, read it after).
IC_PRE_LAUNCHES = 0


def ic_precompute_cluster_size(H: int, W: int) -> int:
    """Blocks of the thread-block cluster that K-ICpre spreads one frame's
    H x W level over: about 2,400 pixels a block, a power of two, at most
    16 (30x40: 1, 60x80: 2, 120x160: 8, 240x320 and 480x640: 16). The
    order of the Gram's pixel sums depends on it, so it is a function of
    the level's shape alone: a frame gets the same factor alone and in a
    batch."""
    # From timing every cluster size per level at B = 1, 16, 128 and 257
    # frames on the card (tools/ktr_ab.py --sweep; PERF.md): the size whose
    # slowest B was closest to that B's best.
    cluster = 1
    while cluster < 16 and cluster * 2_400 < H * W:
        cluster *= 2
    return cluster


def ic_precompute(
    source_intensity: torch.Tensor,  # (H, W) float32
    source_depth: torch.Tensor,  # (H, W) metres
    source_grad_x: torch.Tensor,  # Scharr of the SOURCE intensity
    source_grad_y: torch.Tensor,
    intr: Intrinsics,
    min_depth: float,
    max_depth: float,
):
    """The exact per-level constants: (J8 (8, H*W) = [J0..J5; I0; valid0],
    L (6, 6) lower Cholesky factor of J0^T J0 + 1e-8 I)."""
    H, W = source_intensity.shape
    N = H * W
    zero = torch.zeros(6, dtype=torch.float32, device=source_depth.device)
    # the identity warp's projection and rigid Jacobian at each source pixel
    _, _, _, J_pix, valid = warp_and_jacobian(source_depth, zero, intr, min_depth, max_depth)
    grad = torch.stack([source_grad_x, source_grad_y], dim=-1)  # (H, W, 2)
    validf = valid.to(torch.float32)
    J = torch.einsum("...k,...kj->...j", grad, J_pix) * validf[..., None]
    Jf = J.reshape(N, 6)
    # a tiny Tikhonov floor keeps the factor finite on degenerate levels
    eye = torch.eye(6, dtype=torch.float32, device=J.device)
    L = torch.linalg.cholesky(Jf.T @ Jf + 1e-8 * eye)
    J8 = torch.cat([Jf.T, source_intensity.reshape(1, N), validf.reshape(1, N)], dim=0)
    return J8, L


def _compose_inverse_update(R, t, delta, lam):
    """T <- T . T(lam * delta)^-1 with a ZYX-Euler delta, entry by entry: R
    is a 9-tuple (row-major), t a 3-tuple, delta a 6-tuple of tensors of
    one shape; phovo_tpu/ops/ic.py:99-131's expressions in their order."""
    dx, dy, dz, dyaw, dpitch, droll = (lam * d for d in delta)
    cy, sy = torch.cos(dyaw), torch.sin(dyaw)
    cp, sp = torch.cos(dpitch), torch.sin(dpitch)
    cr, sr = torch.cos(droll), torch.sin(droll)
    D00, D01, D02 = cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr
    D10, D11, D12 = sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr
    D20, D21, D22 = -sp, cp * sr, cp * cr
    # T(d)^-1 = [D^T, -D^T t_d]
    I00, I01, I02 = D00, D10, D20
    I10, I11, I12 = D01, D11, D21
    I20, I21, I22 = D02, D12, D22
    it0 = -(I00 * dx + I01 * dy + I02 * dz)
    it1 = -(I10 * dx + I11 * dy + I12 * dz)
    it2 = -(I20 * dx + I21 * dy + I22 * dz)
    R00, R01, R02, R10, R11, R12, R20, R21, R22 = R
    t0, t1, t2 = t
    n00 = R00 * I00 + R01 * I10 + R02 * I20
    n01 = R00 * I01 + R01 * I11 + R02 * I21
    n02 = R00 * I02 + R01 * I12 + R02 * I22
    n10 = R10 * I00 + R11 * I10 + R12 * I20
    n11 = R10 * I01 + R11 * I11 + R12 * I21
    n12 = R10 * I02 + R11 * I12 + R12 * I22
    n20 = R20 * I00 + R21 * I10 + R22 * I20
    n21 = R20 * I01 + R21 * I11 + R22 * I21
    n22 = R20 * I02 + R21 * I12 + R22 * I22
    nt0 = R00 * it0 + R01 * it1 + R02 * it2 + t0
    nt1 = R10 * it0 + R11 * it1 + R12 * it2 + t1
    nt2 = R20 * it0 + R21 * it1 + R22 * it2 + t2
    return (n00, n01, n02, n10, n11, n12, n20, n21, n22), (nt0, nt1, nt2)


def _tri_solve(L_get, g, inv_diag):
    """Solve (L L^T) x = g by forward and back substitution; L_get(i, j) is
    the factor's entry and inv_diag[i] = 1 / L[i][i], hoisted by the caller
    since the factor is constant for the level (phovo_tpu/ops/ic.py:134)."""
    ys = [None] * 6
    for i in range(6):
        acc = g[i]
        for k in range(i):
            acc = acc - L_get(i, k) * ys[k]
        ys[i] = acc * inv_diag[i]
    xs = [None] * 6
    for i in range(5, -1, -1):
        acc = ys[i]
        for k in range(i + 1, 6):
            acc = acc - L_get(k, i) * xs[k]
        xs[i] = acc * inv_diag[i]
    return xs


def _chol_factor(A):
    """6x6 Cholesky factor, entry by entry (A[i][j] tensors of one shape):
    pivot sqrt(max(acc, 1e-30)) (NaN kept), its reciprocal, then products
    (phovo_tpu/ops/ic.py:500-514). Returns the lower factor as lists; the
    entries above the diagonal are None."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        acc = A[i][i]
        for k in range(i):
            acc = acc - L[i][k] * L[i][k]
        L[i][i] = torch.sqrt(torch.clamp(acc, min=1e-30))
        inv_d = 1.0 / L[i][i]
        for j in range(i + 1, 6):
            acc = A[j][i]
            for k in range(i):
                acc = acc - L[j][k] * L[i][k]
            L[j][i] = acc * inv_d
    return L


def _check_frames(tensors: dict) -> None:
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != 3 or t.shape != first.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected (B, H, W) = {tuple(first.shape)}")
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, intensity on {first.device}")


def ic_precompute_batch(
    intensity: torch.Tensor,  # (B, H, W) source intensities
    depth: torch.Tensor,  # (B, H, W) metres
    grad_x: torch.Tensor,  # (B, H, W) Scharr of the intensities
    grad_y: torch.Tensor,
    intr: Intrinsics,  # at this level
    min_depth: float,
    max_depth: float,
):
    """The IC level constants of B frames: (J8 (B, 8, H*W) = [J0..J5; I0;
    valid], L (B, 36) row-major lower Cholesky factors of J0^T J0 + 1e-8 I)
    at the identity warp (phovo_tpu/ops/ic.py::ic_precompute_pallas). The
    CUDA kernel (K-ICpre, a cluster of blocks per frame) for CUDA tensors, the plain
    version for CPU tensors; any other device, a failed build or launch
    raises."""
    global IC_PRE_LAUNCHES
    if intensity.device.type == "cpu":
        return ic_precompute_batch_reference(intensity, depth, grad_x, grad_y, intr, min_depth, max_depth)
    _check_frames({"intensity": intensity, "depth": depth, "grad_x": grad_x, "grad_y": grad_y})
    if intensity.device.type != "cuda":
        raise ValueError(f"no IC precompute kernel for device {intensity.device}")

    from phovo_tpu_torch.ops import _build

    lib = _build.library()
    B, H, W = intensity.shape
    with torch.cuda.device(intensity.device):
        args, (J8, L) = _ic_precompute_launch_args(
            intensity, depth, grad_x, grad_y, intr, min_depth, max_depth,
            stream=torch.cuda.current_stream(intensity.device).cuda_stream,
        )
        if B:
            err = lib.phovo_ic_precompute(*args)
            if err:
                raise RuntimeError(
                    f"ic_precompute kernel launch failed: CUDA error {err} (B = {B} frames, {H}x{W}, "
                    f"clusters of {ic_precompute_cluster_size(H, W)} blocks by the rule)"
                )
            IC_PRE_LAUNCHES += 1
    return J8, L


def _ic_precompute_launch_args(intensity, depth, grad_x, grad_y, intr, min_depth, max_depth, *,
                               stream=0, cluster=None):
    """phovo_ic_precompute's arguments in its order (csrc/ic_precompute.cu),
    from ic_precompute_batch's arguments, with the outputs they point at:
    (args, (J8, L)). cluster defaults to ic_precompute_cluster_size(H, W);
    another value forces it through the C entry (the card tests and the
    sweep)."""
    B, H, W = intensity.shape
    J8 = torch.empty((B, 8, H * W), dtype=torch.float32, device=intensity.device)
    L = torch.empty((B, 36), dtype=torch.float32, device=intensity.device)
    args = (
        intensity.data_ptr(), depth.data_ptr(), grad_x.data_ptr(), grad_y.data_ptr(),
        J8.data_ptr(), L.data_ptr(), B, H, W,
        ic_precompute_cluster_size(H, W) if cluster is None else int(cluster),
        intr.fx, intr.fy, intr.cx, intr.cy, float(min_depth), float(max_depth), stream,
    )
    return args, (J8, L)


def ic_precompute_batch_reference(intensity, depth, grad_x, grad_y, intr, min_depth, max_depth):
    """Plain torch version of ic_precompute_batch, on any device, in the TPU
    kernel's expression order (phovo_tpu/ops/ic.py:548-599): pixel
    coordinates from the flat index, px = (col - cx) pz / fx a true
    division, the Gram of rows 0..5 by one batched product, then
    _chol_factor."""
    _check_frames({"intensity": intensity, "depth": depth, "grad_x": grad_x, "grad_y": grad_y})
    B, H, W = intensity.shape
    N = H * W
    dev = intensity.device
    pidx = torch.arange(N, dtype=torch.int32, device=dev)
    rows = (pidx // W).to(torch.float32)
    cols = (pidx % W).to(torch.float32)
    # a 0-dim tensor on the device, not a Python float: torch's CUDA divide
    # by a host scalar multiplies by its reciprocal instead
    fx_t, fy_t = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (intr.fx, intr.fy))
    fx, fy = intr.fx, intr.fy
    d0 = depth.reshape(B, N)
    gx = grad_x.reshape(B, N)
    gy = grad_y.reshape(B, N)
    pz = d0
    px = (cols - intr.cx) * pz / fx_t
    py = (rows - intr.cy) * pz / fy_t
    validf = ((d0 > min_depth) & (d0 < max_depth)).to(torch.float32)
    safe_z = torch.where(pz > 1e-12, pz, torch.full_like(pz, 1e-12))
    iz = 1.0 / safe_z
    a0 = fx * iz
    a2 = -fx * px * iz * iz
    b1 = fy * iz
    b2 = -fy * py * iz * iz
    # rigid columns at zero angles (ZYX): dR/dyaw|0 p = (-py, px, 0),
    # dR/dpitch|0 p = (pz, 0, -px), dR/droll|0 p = (0, -pz, py)
    J8 = torch.stack([
        gx * a0 * validf,
        gy * b1 * validf,
        (gx * a2 + gy * b2) * validf,
        (gx * (a0 * -py) + gy * (b1 * px)) * validf,
        (gx * (a0 * pz + a2 * -px) + gy * (b2 * -px)) * validf,
        (gx * (a2 * py) + gy * (b1 * -pz + b2 * py)) * validf,
        intensity.reshape(B, N),
        validf,
    ], dim=1)  # (B, 8, N)
    J = J8[:, :6]
    gram = torch.bmm(J, J.transpose(1, 2))
    A = [[gram[:, i, j] + 1e-8 if i == j else gram[:, i, j] for j in range(6)] for i in range(6)]
    L = _chol_factor(A)
    zero = torch.zeros(B, dtype=torch.float32, device=dev)
    Lrow = torch.stack([L[i][j] if j <= i else zero for i in range(6) for j in range(6)], dim=1)
    return J8, Lrow


def ic_gn_level(
    T: torch.Tensor,  # (4, 4) current pose
    geom: torch.Tensor,  # (4, H*W) ops/fused.pack_geometry rows; row 3 unread
    J8: torch.Tensor,  # (8, H*W)
    L: torch.Tensor,  # (36,) row-major factor, or (6, 6)
    target_intensity: torch.Tensor,  # (H, W)
    intr: Intrinsics,
    max_iterations: int,
    min_gradient_norm: float,
    lambda_step: float,
    sampling: str = "nearest",
    mix_mode: str = "f32",
):
    """One whole IC level for one pair (phovo_tpu/ops/ic.py::ic_gn_level):
    the level kernel (ops/ic_batch.ic_gn_level_batch, K-IC) at B = 1 on
    CUDA tensors, its plain version on CPU tensors. Returns (T', iterations,
    gradient_norm, cost, num_valid, band_masked = 0)."""
    from phovo_tpu_torch.ops.ic_batch import ic_gn_level_batch

    H, W = target_intensity.shape
    res = ic_gn_level_batch(
        T.to(torch.float32).reshape(1, 4, 4), geom[None].contiguous(), J8[None].contiguous(),
        L.to(torch.float32).reshape(1, 36).contiguous(), target_intensity[None].contiguous(),
        intr, max_iterations, min_gradient_norm, lambda_step, H=H, W=W,
        sampling=sampling, mix_mode=mix_mode,
    )
    return tuple(x[0] for x in res)


def ic_gn_level_exact(
    T: torch.Tensor,  # (4, 4)
    source_depth: torch.Tensor,  # (H, W)
    J8: torch.Tensor,  # (8, H*W) from ic_precompute
    L: torch.Tensor,  # (6, 6) lower factor
    target_intensity: torch.Tensor,  # (H, W)
    intr: Intrinsics,
    max_iterations: int,
    min_gradient_norm: float,
    lambda_step: float,
    sampling: str = "nearest",
):
    """The exact IC level (phovo_tpu/ops/ic.py::ic_gn_level_xla): per
    iteration the warped target sample by ops/warp, g = J0^T r,
    torch.cholesky_solve against the frozen factor, and
    T <- T . pose_matrix(lambda delta)^-1, kept only when delta is finite.
    Returns (T', iterations, gradient_norm (0 if none ran), cost,
    num_valid, band_masked = 0)."""
    H, W = source_depth.shape
    N = H * W
    dev = source_depth.device
    Jrows = J8[:6]
    i0 = J8[6].reshape(H, W)
    valid0 = J8[7].reshape(H, W) > 0.5
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev), indexing="ij",
    )
    pz = source_depth
    px = (xs - intr.cx) * pz / intr.fx
    py = (ys - intr.cy) * pz / intr.fy
    sample = sample_bilinear if sampling == "bilinear" else sample_nearest

    def linearize(T):
        R, t = T[:3, :3], T[:3, 3]
        tx = R[0, 0] * px + R[0, 1] * py + R[0, 2] * pz + t[0]
        ty = R[1, 0] * px + R[1, 1] * py + R[1, 2] * pz + t[1]
        tz = R[2, 0] * px + R[2, 1] * py + R[2, 2] * pz + t[2]
        safe_z = torch.where(torch.abs(tz) > 1e-12, tz, torch.full_like(tz, 1e-12))
        u = tx * intr.fx / safe_z + intr.cx
        v = ty * intr.fy / safe_z + intr.cy
        i1w, inb = sample(target_intensity, u, v)
        valid = valid0 & inb & (tz > 0)
        r = torch.where(valid, i1w - i0, torch.zeros_like(i1w)).reshape(N)
        return Jrows @ r, torch.sum(r * r), torch.sum(valid.to(torch.float32))

    T = T.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    it, gnorm, cost, nvalid = 0, float("inf"), zero, zero
    gnorm_t = zero
    while it < max_iterations and gnorm >= min_gradient_norm:
        g, cost, nvalid = linearize(T)
        delta = torch.cholesky_solve(g[:, None], L, upper=False)[:, 0]
        if bool(torch.isfinite(delta).all()):
            T = T @ se3.inverse(se3.pose_matrix(lambda_step * delta))
        gnorm_t = torch.linalg.vector_norm(g)
        gnorm = float(gnorm_t)
        it += 1
    gnorm_t = torch.where(torch.isfinite(gnorm_t), gnorm_t, zero)
    return T, torch.tensor(it, dtype=torch.int32, device=dev), gnorm_t, cost, nvalid, zero
