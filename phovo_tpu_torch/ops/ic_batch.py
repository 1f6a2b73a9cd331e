"""One whole inverse-compositional Gauss-Newton level for B independent
pairs (torch port of phovo_tpu/ops/ic_batch.py::ic_gn_level_batch and, at
B = 1, phovo_tpu/ops/ic.py::ic_gn_level).

On a CUDA tensor ic_gn_level_batch launches the hand-written kernel
csrc/ic_gn_batch.cu (K-IC: one thread-block cluster of
ic_cluster_size(H, W) blocks per pair, the level's whole iteration loop
inside the cluster, each pair stopping on its own; each block's share of
the pack resident in shared memory where ic_resident says). On a CPU
tensor it runs the plain batched torch version, ic_gn_level_batch_reference:
every pair advances in lockstep and freezes once its gradient norm falls
below the threshold or its budget is spent, the per-pair semantics of the
TPU kernels. Both write the per-pixel warp, the one-channel target sample,
the residual and the frozen-factor solve in the TPU kernel's order
(phovo_tpu/ops/ic.py:179-331, ops/ic.py here), so only the order of the
pixel sums differs between them. The TPU kernel samples through one-hot
matrix products against a banded row window; here the target is read by
direct gather, so no pixel is masked and band_masked is always 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.ic import _compose_inverse_update, _tri_solve

# Launches of K-IC in this process. The wrapper adds one per launch and
# nowhere else, so a caller can show that its run went through the kernel
# (reset it to 0 before the run, read it after).
IC_LAUNCHES = 0

_SAMPLINGS = ("nearest", "bilinear")

# Threads of a block of the IC kernels (csrc/phovo_linearize.cuh kThreads).
THREADS = 256
# Dynamic shared memory one block may use on an H100 (227 KB).
SMEM_PER_BLOCK = 232_448
# A bound on K-IC's static shared memory (its pose, factor, sums and
# cluster slots; ptxas counts 528 bytes one block a pair, 592 in a
# cluster: tools/ktr_ab.py prints it for each kernel).
IC_STATIC_SMEM = 1_024
# The rows a resident block keeps of each of its pixels: geometry rows 0-2
# and J8 rows 0-7 (csrc/ic_gn_batch.cu kPackRows).
PACK_ROWS = 11


def ic_cluster_size(H: int, W: int) -> int:
    """Blocks of the thread-block cluster that K-IC spreads one pair's
    H x W level over: 1 up to 60x80 (4,800 pixels), 16 above. The order of
    the pixel sums depends on it, so it is a function of the level's shape
    alone, never of B: a pair gives the same bits alone, in a batch and on
    the per-pair route."""
    # From timing every cluster size per level at B = 1, 16, 128 and 256 on
    # the card (tools/ktr_ab.py --sweep; PERF.md). Above 60x80, 16 blocks
    # (Hopper's largest cluster, non-portable) led at B = 1, 16 and 128;
    # at 256 pairs 2 blocks led by 2% at 480x640 and 9% at 240x320. At
    # 60x80 one resident block a pair led the chain's 128 and 256 pairs
    # (clusters cost them 6% and more); at 30x40 one block led at every B:
    # there an iteration is mostly its serial tail, which every block of a
    # cluster would repeat.
    return 1 if H * W <= 4_800 else 16


def ic_pack_bytes(H: int, W: int, cluster: int) -> int:
    """Dynamic shared memory of a resident K-IC block: PACK_ROWS rows of
    the pixels of the cluster's block with the most, rounded up to whole
    sweeps of THREADS (csrc/ic_gn_batch.cu pack_slots)."""
    sweep = cluster * THREADS
    return PACK_ROWS * 4 * (-(-(H * W) // sweep) * THREADS)


def ic_pack_fits(H: int, W: int, cluster: int) -> bool:
    """Whether a resident K-IC block's pack fits beside its static shared
    memory in what a block may use: the layouts the kernel can run
    resident (a launch past it is refused)."""
    return ic_pack_bytes(H, W, cluster) + IC_STATIC_SMEM <= SMEM_PER_BLOCK


def ic_resident(H: int, W: int, cluster: int) -> bool:
    """Whether K-IC keeps each block's share of the pack in shared memory
    for the whole level at this shape and cluster size: at 120x160 (19,200
    pixels) and below, where it fits beside the static shared memory. A
    resident level gives the bits of a streamed one at the same cluster
    size."""
    # From the same sweep: resident led wherever it fits up to 120x160; at
    # 240x320 (only 16 blocks a pair fit, 214 KB, one block an SM) it cost
    # 128 and 256 pairs 47-49% for a 14% gain at B = 1.
    return H * W <= 19_200 and ic_pack_fits(H, W, cluster)


class ICLevelBatchResult(NamedTuple):
    """phovo_tpu's ic_gn_level_batch result, in its order."""

    T: torch.Tensor  # (B, 4, 4) float32 poses
    iterations: torch.Tensor  # (B,) int32 updates performed
    gradient_norm: torch.Tensor  # (B,) ||J0^T r|| of the last update (0 if non-finite)
    cost: torch.Tensor  # (B,) sum r^2 at the last linearization
    num_valid: torch.Tensor  # (B,) valid pixels at the last linearization
    band_masked: torch.Tensor  # (B,) always 0: the GPU samples the whole target


def _check_inputs(Ts, geom, J8, L, t_i, H, W, sampling) -> None:
    if sampling not in _SAMPLINGS:
        raise ValueError(f"sampling={sampling!r}; expected one of {_SAMPLINGS}")
    tensors = {"Ts": Ts, "geom": geom, "J8": J8, "L": L, "t_i": t_i}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != geom.device:
            raise ValueError(f"{name} is on {t.device}, geom on {geom.device}")
    B, N = Ts.shape[0], H * W
    expected = {"Ts": (B, 4, 4), "geom": (B, 4, N), "J8": (B, 8, N), "L": (B, 36), "t_i": (B, H, W)}
    for name, t in tensors.items():
        if tuple(t.shape) != expected[name]:
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}, expected {expected[name]} "
                f"for B={B} pairs at {H}x{W}"
            )


def _poses(R, t) -> torch.Tensor:
    """(9 rotation entries, 3 translation entries), each (B,) -> (B, 4, 4)."""
    B = R[0].shape[0]
    T = torch.eye(4, dtype=torch.float32, device=R[0].device).repeat(B, 1, 1)
    T[:, :3, :3] = torch.stack(R, dim=1).reshape(B, 3, 3)
    T[:, :3, 3] = torch.stack(t, dim=1)
    return T


def ic_gn_level_batch(
    Ts: torch.Tensor,  # (B, 4, 4) current poses
    geom: torch.Tensor,  # (B, 4, H*W) ops/fused.pack_geometry rows; row 3 unread
    J8: torch.Tensor,  # (B, 8, H*W) ops/ic.ic_precompute_batch rows
    L: torch.Tensor,  # (B, 36) row-major Cholesky factors
    t_i: torch.Tensor,  # (B, H, W) target intensities
    intr: Intrinsics,  # at this level
    max_iterations: int,
    min_gradient_norm: float,
    lambda_step: float,
    *,
    H: int,
    W: int,
    sampling: str = "nearest",
    mix_mode: str = "f32",
) -> ICLevelBatchResult:
    """Run ONE whole IC level for B independent pairs: the CUDA kernel for
    CUDA tensors, the plain torch version for CPU tensors. Any other device
    raises; so does a failed build or launch (there is no fallback).
    Validity comes from J8's row 7 (the source's depth range) and the
    warp; the geometry's valid row is not read. mix_mode (phovo_tpu's
    sampling-matmul precision) is accepted and the level computes in
    float32 whatever it says."""
    global IC_LAUNCHES
    if geom.device.type == "cpu":
        return ic_gn_level_batch_reference(
            Ts, geom, J8, L, t_i, intr, max_iterations, min_gradient_norm,
            lambda_step, H=H, W=W, sampling=sampling,
        )
    Ts = Ts.to(torch.float32).contiguous()
    _check_inputs(Ts, geom, J8, L, t_i, H, W, sampling)
    if geom.device.type != "cuda":
        raise ValueError(f"no IC level kernel for device {geom.device}")

    from phovo_tpu_torch.ops import _build

    lib = _build.library()
    with torch.cuda.device(geom.device):
        args, (_, state_out, diag) = _ic_launch_args(
            Ts, geom, J8, L, t_i, intr, max_iterations, min_gradient_norm, lambda_step,
            H=H, W=W, sampling=sampling, stream=torch.cuda.current_stream(geom.device).cuda_stream,
        )
        if Ts.shape[0]:
            err = lib.phovo_ic_gn_level_batch(*args)
            if err:
                c = ic_cluster_size(H, W)
                raise RuntimeError(
                    f"ic_gn_batch kernel launch failed: CUDA error {err} (B = {Ts.shape[0]} pairs, "
                    f"{H}x{W}, clusters of {c} blocks, resident {ic_resident(H, W, c)} by the rule)"
                )
            IC_LAUNCHES += 1
    cols = diag.t().contiguous()
    return ICLevelBatchResult(
        _poses(state_out[:, :9].unbind(1), state_out[:, 9:].unbind(1)),
        cols[0].to(torch.int32), cols[1], cols[2], cols[3], torch.zeros_like(cols[0]),
    )


def _ic_launch_args(Ts, geom, J8, L, t_i, intr, max_iterations, min_gradient_norm,
                    lambda_step, *, H, W, sampling="nearest", stream=0, cluster=None,
                    resident=None):
    """phovo_ic_gn_level_batch's arguments in its order
    (csrc/ic_gn_batch.cu), from ic_gn_level_batch's arguments (Ts float32
    and contiguous), with the tensors they point at: (args, (state_in,
    state_out, diag_out)). cluster defaults to ic_cluster_size(H, W) and
    resident to ic_resident(H, W, cluster); other values force them
    through the C entry (the card tests and the sweep)."""
    B = Ts.shape[0]
    cluster = ic_cluster_size(H, W) if cluster is None else int(cluster)
    resident = ic_resident(H, W, cluster) if resident is None else bool(resident)
    state_in = torch.cat([Ts[:, :3, :3].reshape(B, 9), Ts[:, :3, 3]], dim=1).contiguous()
    state_out = torch.empty((B, 12), dtype=torch.float32, device=geom.device)
    diag = torch.empty((B, 4), dtype=torch.float32, device=geom.device)
    args = (
        state_in.data_ptr(), geom.data_ptr(), J8.data_ptr(), L.data_ptr(), t_i.data_ptr(),
        state_out.data_ptr(), diag.data_ptr(), B, H, W, int(sampling == "bilinear"), cluster,
        int(resident), intr.fx, intr.fy, intr.cx, intr.cy, int(max_iterations),
        float(min_gradient_norm), float(lambda_step), stream,
    )
    return args, (state_in, state_out, diag)


def _level_pass(R, t, geom, J8, t_flat, intr, H, W, bilinear):
    """One linearization of B pairs at poses (R, t), entries (B,): (g [6]
    (B,), cost (B,), nvalid (B,)) in the TPU kernel's order of operations."""
    fx, fy, cx, cy = intr
    R00, R01, R02, R10, R11, R12, R20, R21, R22 = (x[:, None] for x in R)
    t0, t1, t2 = (x[:, None] for x in t)
    px, py, pz = geom[:, 0], geom[:, 1], geom[:, 2]
    tx = R00 * px + R01 * py + R02 * pz + t0
    ty = R10 * px + R11 * py + R12 * pz + t1
    tz = R20 * px + R21 * py + R22 * pz + t2
    safe_z = torch.where(torch.abs(tz) > 1e-12, tz, torch.full_like(tz, 1e-12))
    iz = 1.0 / safe_z
    u = tx * fx * iz + cx
    v = ty * fy * iz + cy
    valid = (J8[:, 7] > 0.5) & (tz > 0)
    if bilinear:
        c0 = torch.floor(u)
        r0 = torch.floor(v)
        fc = u - c0
        fr = v - r0
        valid = valid & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    else:
        c0 = torch.round(u)  # half to even, as jnp.round and rintf
        r0 = torch.round(v)
        valid = valid & (c0 >= 0) & (c0 <= W - 1) & (r0 >= 0) & (r0 <= H - 1)

    def sample(rows, cols):
        # clamp in float, convert, clamp again: NaN converts to an
        # arbitrary integer, and gather must never read out of range
        ri = torch.clamp(rows, 0, H - 1).to(torch.int64).clamp_(0, H - 1)
        ci = torch.clamp(cols, 0, W - 1).to(torch.int64).clamp_(0, W - 1)
        return torch.gather(t_flat, 1, ri * W + ci)

    if bilinear:
        top = sample(r0, c0) * (1 - fc) + sample(r0, c0 + 1) * fc
        bot = sample(r0 + 1, c0) * (1 - fc) + sample(r0 + 1, c0 + 1) * fc
        i1w = top * (1 - fr) + bot * fr
    else:
        i1w = sample(r0, c0)
    validf = valid.to(torch.float32)
    r = (i1w - J8[:, 6]) * validf
    g = [torch.sum(J8[:, i] * r, dim=1) for i in range(6)]
    return g, torch.sum(r * r, dim=1), torch.sum(validf, dim=1)


def ic_gn_level_batch_reference(
    Ts: torch.Tensor,
    geom: torch.Tensor,
    J8: torch.Tensor,
    L: torch.Tensor,
    t_i: torch.Tensor,
    intr: Intrinsics,
    max_iterations: int,
    min_gradient_norm: float,
    lambda_step: float,
    *,
    H: int,
    W: int,
    sampling: str = "nearest",
    mix_mode: str = "f32",
) -> ICLevelBatchResult:
    """Plain batched torch version of ic_gn_level_batch, on any device, with
    its signature (mix_mode accepted, float32 throughout). A Python while
    loop over iterations runs until every pair froze; a frozen pair's pose
    and diagnostics stop changing, and a pair whose step is not finite
    keeps its pose (phovo_tpu/ops/ic_batch.py:256-278)."""
    del mix_mode
    Ts = Ts.to(torch.float32).contiguous()
    _check_inputs(Ts, geom, J8, L, t_i, H, W, sampling)
    B = Ts.shape[0]
    t_flat = t_i.reshape(B, H * W)
    R = [Ts[:, i, j] for i in range(3) for j in range(3)]
    t = [Ts[:, i, 3] for i in range(3)]

    def L_get(i, j):
        return L[:, i * 6 + j]

    # the factor is frozen for the level: its reciprocal pivots once
    inv_diag = [1.0 / L_get(i, i) for i in range(6)]
    zero = torch.zeros(B, dtype=torch.float32, device=geom.device)
    it, gnorm = zero, torch.full_like(zero, float("inf"))
    cost, nvalid = zero, zero
    while True:
        act = (it < max_iterations) & (gnorm >= min_gradient_norm)
        if not bool(act.any()):
            break
        g, cost_i, nvalid_i = _level_pass(R, t, geom, J8, t_flat, intr, H, W, sampling == "bilinear")
        delta = _tri_solve(L_get, g, inv_diag)
        finite = torch.stack([torch.isfinite(d) for d in delta]).all(dim=0)
        newR, newt = _compose_inverse_update(R, t, delta, lambda_step)
        upd = act & finite
        R = [torch.where(upd, n, o) for n, o in zip(newR, R)]
        t = [torch.where(upd, n, o) for n, o in zip(newt, t)]
        g2 = g[0] * g[0]
        for k in range(1, 6):
            g2 = g2 + g[k] * g[k]
        it = it + act.to(torch.float32)
        gnorm = torch.where(act, torch.sqrt(g2), gnorm)
        cost = torch.where(act, cost_i, cost)
        nvalid = torch.where(act, nvalid_i, nvalid)
    return ICLevelBatchResult(
        _poses(R, t), it.to(torch.int32),
        torch.where(torch.isfinite(gnorm), gnorm, zero), cost, nvalid, zero,
    )
