"""One whole pyramid level for B independent pairs: Gauss-Newton (torch
port of phovo_tpu/ops/fused_batch.py::fused_gn_level_batch and, at B = 1,
phovo_tpu/ops/fused.py::fused_gn_level_packs), photometric or bi-objective
(intensity + depth, with depth_gains), and trust-region
Levenberg-Marquardt (::fused_tr_level_batch); and one linearization of B
pairs (phovo_tpu/ops/fused.py::_fused_kernel).

On a CUDA tensor each wrapper launches its hand-written kernel,
csrc/fused_gn_batch.cu, csrc/fused_tr_batch.cu (one thread-block cluster
per pair, of cluster_size(H, W) blocks, the level's whole iteration loop
inside the cluster) or csrc/fused_lin.cu (one linearization, each pair
split over lin_split(H, W) blocks whose sums meet in a fixed order). The
two level kernels also take one source pack shared by every pair
(keyframe tracking: phovo_tpu's shared_source mode), which gives the bits
of the same pack repeated B times. On a CPU tensor
it runs the plain batched torch version of the same function
(fused_gn_level_batch_reference, fused_tr_level_batch_reference,
fused_lin_batch_reference): every pair advances in lockstep and freezes on
its own once its termination test fires or its iteration budget is spent,
exactly the per-pair semantics of the TPU kernels. Kernel and plain
version write the per-pixel arithmetic, robust weights, ESM gradient and
depth row included, in the same order (phovo_tpu/ops/fused_batch.py::
_batch_linearize, ops/robust.py), so only the order of the pixel sums
differs between them: the bi-objective plain version sums the intensity
and depth channels separately and adds the sums, as phovo_tpu does
(fused_batch.py:572-582); the kernel adds each pixel's depth products into
the same 29 sums as its intensity products.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.robust import LOSSES, sqrt_weight, tdist_scale_update
from phovo_tpu_torch.utils import profiling

# Launches of the CUDA kernel in this process. The wrapper adds one per
# launch, and a replay of a captured call (models/base.CallGraph: the
# object API's pair, the serving round) the launches it holds, so a caller
# can show that its run went through the kernel (reset it to 0 before the
# run, read it after).
LAUNCHES = 0
# Launches of the trust-region kernel, with the same contract.
TR_LAUNCHES = 0
# Launches of the one-linearization kernel, with the same contract.
LIN_LAUNCHES = 0
# Of LAUNCHES and TR_LAUNCHES, the launches with a shared source (one
# keyframe's pack read by every pair), with the same contract.
SHARED_LAUNCHES = 0
TR_SHARED_LAUNCHES = 0
# Of LAUNCHES, the bi-objective variant's (K-GN-bi: depth_gains given),
# with the same contract.
BI_LAUNCHES = 0

_SAMPLINGS = ("nearest", "bilinear")
# the one-linearization kernel's sums a block (csrc/phovo_linearize.cuh
# kGramSums): JtJ's upper triangle, J^T r, cost, count, J^T valid
_GRAM_SUMS = 35
# the kernels' loss codes (csrc/phovo_linearize.cuh enum Loss)
_LOSS_CODES = {name: code for code, name in enumerate(LOSSES)}

def cluster_size(H: int, W: int) -> int:
    """Blocks of the thread-block cluster that K-GN and K-TR spread one
    pair's H x W level over: 1 up to 60x80 (4,800 pixels), 8 above. The
    order of the pixel sums depends on it, so it is a function of the
    level's shape alone, never of B, the mode or the variant: a pair gives
    the same bits alone, in a batch, against a shared source and as a
    served stream."""
    # From timing every cluster size per level on the card (tools/ktr_ab.py
    # --sweep; PERF.md). At 30x40 and 60x80 a pair's iteration is mostly
    # the serial tail (two block barriers, the 6x6 solve on one thread),
    # which every block of a cluster would repeat, so they keep one block.
    # 16 blocks halve a lone 480x640 pair's time against 8, but cost a
    # 256-pair launch 5-10%, since fewer clusters of 16 fit the card at once.
    return 1 if H * W <= 4_800 else 8


class LevelBatchResult(NamedTuple):
    state: torch.Tensor  # (B, 6) float32
    iterations: torch.Tensor  # (B,) int32 GN updates performed
    gradient_norm: torch.Tensor  # (B,) ||J^T r|| of the last update (0 if non-finite)
    cost: torch.Tensor  # (B,) sum r^2 at the last linearization
    num_valid: torch.Tensor  # (B,) valid pixels at the last linearization
    band_masked: torch.Tensor  # (B,) always 0: the GPU samples the whole target
    # (B,) the loss's final scale: the Student-t sigma after the last
    # linearization for 'tdist' (its robust_scale in when no iteration ran),
    # the scale given in for every other loss
    robust_scale: torch.Tensor


class TRLevelBatchResult(NamedTuple):
    """phovo_tpu's fused_tr_level_batch result, in its order."""

    state: torch.Tensor  # (B, 6) float32
    iterations: torch.Tensor  # (B,) int32 LM iterations (accepted or not)
    cost: torch.Tensor  # (B,) 0.5 sum r^2 at the last accepted linearization
    gradient_norm: torch.Tensor  # (B,) max |J^T r| there (the max-norm)
    radius: torch.Tensor  # (B,) final trust-region radius
    num_valid: torch.Tensor  # (B,) valid pixels there
    band_masked: torch.Tensor  # (B,) always 0: the GPU samples the whole target


def _check_inputs(i0, geom, t_all, init_states, H, W, sampling, esm=False,
                  robust_loss="none", robust_scale=None, depth_gains=None) -> bool:
    """Raise on what the kernels do not take. depth_gains selects the
    bi-objective level: a six-channel target, no ESM, no Student-t (as in
    phovo_tpu); a six-channel target without it is refused. Returns whether
    the source is shared: i0 (1, N) and geom (1, GR, N) with B > 1 pairs'
    targets, one source pack (a keyframe) read by every pair; photometric
    only, as phovo_tpu has no caller for a shared bi-objective source."""
    if sampling not in _SAMPLINGS:
        raise ValueError(f"sampling={sampling!r}; expected one of {_SAMPLINGS}")
    if robust_loss not in LOSSES:
        raise ValueError(f"robust_loss={robust_loss!r}; expected one of {LOSSES}")
    bi = depth_gains is not None
    if bi and esm:
        raise ValueError("gradient_at='esm' is photometric-only: the bi-objective level takes no ESM geometry")
    if bi and robust_loss == "tdist":
        raise ValueError(
            "robust_loss='tdist' is photometric-only (the intensity and depth "
            "channels would need separate adaptive scales); use "
            "huber/cauchy/tukey for the bi-objective level"
        )
    tensors = {"i0": i0, "geom": geom, "t_all": t_all, "init_states": init_states}
    if robust_scale is not None:
        tensors["robust_scale"] = robust_scale
    if bi:
        tensors["depth_gains"] = depth_gains
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != i0.device:
            raise ValueError(f"{name} is on {t.device}, i0 on {i0.device}")
    if t_all.dim() == 4 and t_all.shape[1] == 6 and not bi:
        raise ValueError(
            "a six-channel (bi-objective) target needs depth_gains, one "
            "depth gain per pair"
        )
    B = t_all.shape[0] if t_all.dim() == 4 else -1
    shared = B != 1 and i0.dim() == 2 and i0.shape[0] == 1
    if shared and bi:
        raise ValueError(
            "a shared source (keyframe tracking) is photometric: the "
            "bi-objective level takes one source per pair"
        )
    N = H * W
    S = 1 if shared else B  # source packs
    expected = {
        "i0": (S, N), "geom": (S, 6 if esm else 4, N), "t_all": (B, 6 if bi else 3, H, W),
        "init_states": (B, 6), "robust_scale": (B,), "depth_gains": (B,),
    }
    for name, t in tensors.items():
        if tuple(t.shape) != expected[name]:
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}, expected "
                f"{expected[name]} for B={B} pairs at {H}x{W} (esm={esm}, "
                f"bi-objective={bi}, shared source={shared})"
            )
    return shared


def _shared_views(i0, geom, B):
    """A shared source's (1, N) and (1, GR, N) packs as (B, N) and (B, GR,
    N) views: the plain versions then compute every pair from the same
    values the replicated pack holds."""
    return i0.expand(B, -1), geom.expand(B, -1, -1)


def _scales(robust_delta, robust_scale, B, device) -> torch.Tensor:
    """(B,) float32 loss scale per pair: robust_scale (the carried Student-t
    sigma) when given, else robust_delta for every pair."""
    if robust_scale is not None:
        return robust_scale
    return torch.full((B,), float(robust_delta), dtype=torch.float32, device=device)


def fused_gn_level_batch(
    i0: torch.Tensor,  # (B | 1, H*W) source intensities (1: shared)
    geom: torch.Tensor,  # (B | 1, 4 | 6, H*W) pack_geometry rows (6 with ESM)
    t_all: torch.Tensor,  # (B, 3 | 6, H, W) pack_target stacks (6 bi-objective)
    intr: Intrinsics,  # at this level
    init_states: torch.Tensor,  # (B, 6)
    max_iterations: int,
    min_gradient_norm: float,
    lambda_step: float,
    *,
    H: int,
    W: int,
    sampling: str = "nearest",
    robust_loss: str = "none",
    robust_delta: float = 0.1,
    esm: bool = False,
    robust_scale: torch.Tensor | None = None,  # (B,) tdist sigma in
    tdist_burnin: int = 0,
    depth_gains: torch.Tensor | None = None,  # (B,) -> the bi-objective level
) -> LevelBatchResult:
    """Run ONE whole GN level for B independent pairs: the CUDA kernel for
    CUDA tensors, the plain torch version for CPU tensors. Any other device
    raises; so does a failed build or launch (there is no fallback).

    robust_loss weights every pixel by sqrt(w(r)) (ops/robust.py) at scale
    robust_delta; for 'tdist' the scale is each pair's sigma, robust_scale
    (default robust_delta), which runs tdist_burnin scale-only passes at
    the initial state and is re-estimated after every linearization; the
    result's robust_scale is the final sigma. esm takes the source
    gradients from geometry rows 4 and 5 (ESM Jacobian). depth_gains
    selects the bi-objective level (phovo_tpu's bi mode, K-GN-bi): t_all
    holds [I, gx, gy, D, dgx, dgy] per pair and each pixel adds its depth
    residual gain (D(warped) - tz) and row to the normal equations; 'none',
    huber, cauchy and tukey, without ESM. A source pack shared by every
    pair (i0 (1, N), geom (1, GR, N), B taken from t_all: the keyframe of
    a tracked chunk) gives the bits of the same pack repeated B times, in
    the kernel and in the plain version; photometric, every loss and ESM."""
    global LAUNCHES, SHARED_LAUNCHES, BI_LAUNCHES
    with profiling.span("phovo.level"):
        if i0.device.type == "cpu":
            return fused_gn_level_batch_reference(
                i0, geom, t_all, intr, init_states, max_iterations,
                min_gradient_norm, lambda_step, H=H, W=W, sampling=sampling,
                robust_loss=robust_loss, robust_delta=robust_delta, esm=esm,
                robust_scale=robust_scale, tdist_burnin=tdist_burnin,
                depth_gains=depth_gains,
            )
        shared = _check_inputs(i0, geom, t_all, init_states, H, W, sampling, esm, robust_loss, robust_scale,
                               depth_gains)
        if i0.device.type != "cuda":
            raise ValueError(f"no level kernel for device {i0.device}")

        from phovo_tpu_torch.ops import _build

        lib = _build.library()
        with torch.cuda.device(i0.device):
            args, (states, diag, _) = _gn_launch_args(
                i0, geom, t_all, intr, init_states, max_iterations, min_gradient_norm,
                lambda_step, H=H, W=W, shared=shared, sampling=sampling, robust_loss=robust_loss,
                robust_delta=robust_delta, esm=esm, robust_scale=robust_scale,
                tdist_burnin=tdist_burnin, depth_gains=depth_gains,
                stream=torch.cuda.current_stream(i0.device).cuda_stream,
            )
            if t_all.shape[0]:
                _raise_on_launch_error("fused_gn_batch", lib.phovo_fused_gn_level_batch(*args), t_all.shape[0], H, W)
                LAUNCHES += 1
                SHARED_LAUNCHES += shared
                BI_LAUNCHES += depth_gains is not None
        # one contiguous (B,) row per diagnostic: the sigma out goes back in
        # as the next level's robust_scale
        cols = diag.t().contiguous()
        return LevelBatchResult(states, cols[0].to(torch.int32), *cols[1:])


def _raise_on_launch_error(kernel: str, err: int, B: int, H: int, W: int) -> None:
    if err:
        raise RuntimeError(
            f"{kernel} kernel launch failed: CUDA error {err} (B = {B} pairs, "
            f"{H}x{W}, clusters of {cluster_size(H, W)} blocks by the rule)"
        )


def _gn_launch_args(i0, geom, t_all, intr, init_states, max_iterations,
                    min_gradient_norm, lambda_step, *, H, W, shared=None,
                    sampling="nearest", robust_loss="none", robust_delta=0.1,
                    esm=False, robust_scale=None, tdist_burnin=0,
                    depth_gains=None, stream=0, cluster=None):
    """phovo_fused_gn_level_batch's arguments in its order
    (csrc/fused_gn_batch.cu), from fused_gn_level_batch's arguments, with
    the tensors they point at: (args, (states_out, diag_out, scale_in)).
    shared is _check_inputs' answer for them; None checks them here.
    cluster defaults to cluster_size(H, W); another value forces a cluster
    size through the C entry (the card tests and the timing of the rule
    against one block a pair)."""
    if shared is None:
        shared = _check_inputs(i0, geom, t_all, init_states, H, W, sampling, esm, robust_loss, robust_scale,
                               depth_gains)
    B = t_all.shape[0]
    scale_in = _scales(robust_delta, robust_scale, B, i0.device)
    states = torch.empty((B, 6), dtype=torch.float32, device=i0.device)
    diag = torch.empty((B, 6), dtype=torch.float32, device=i0.device)
    args = (
        i0.data_ptr(), geom.data_ptr(), t_all.data_ptr(), init_states.data_ptr(),
        scale_in.data_ptr(), None if depth_gains is None else depth_gains.data_ptr(),
        states.data_ptr(), diag.data_ptr(), B, H, W, int(sampling == "bilinear"),
        _LOSS_CODES[robust_loss], int(esm), int(shared),
        cluster_size(H, W) if cluster is None else int(cluster),
        intr.fx, intr.fy, intr.cx, intr.cy, int(max_iterations),
        float(min_gradient_norm), float(lambda_step), int(tdist_burnin), stream,
    )
    return args, (states, diag, scale_in)


def _rotation_terms(s3, s4, s5):
    """ZYX rotation R(yaw, pitch, roll) and the derivative rows the
    Jacobian needs, in the expression order of _batch_linearize."""
    cyw, syw = torch.cos(s3), torch.sin(s3)
    cp, sp = torch.cos(s4), torch.sin(s4)
    cr, sr = torch.cos(s5), torch.sin(s5)
    R = (
        cyw * cp, cyw * sp * sr - syw * cr, cyw * sp * cr + syw * sr,
        syw * cp, syw * sp * sr + cyw * cr, syw * sp * cr - cyw * sr,
        -sp, cp * sr, cp * cr,
    )
    dY = (
        -syw * cp, -syw * sp * sr - cyw * cr, -syw * sp * cr + cyw * sr,
        cyw * cp, cyw * sp * sr - syw * cr, cyw * sp * cr + syw * sr,
    )
    dP = (
        -cyw * sp, cyw * cp * sr, cyw * cp * cr,
        -syw * sp, syw * cp * sr, syw * cp * cr,
        -cp, -sp * sr, -sp * cr,
    )
    dR = (
        cyw * sp * cr + syw * sr, -cyw * sp * sr + syw * cr,
        syw * sp * cr - cyw * sr, -syw * sp * sr - cyw * cr,
        cp * cr, -cp * sr,
    )
    return R, dY, dP, dR


def _sample(t_flat, idx):
    """(B, C, H*W) stacks gathered at (B, N) flat indices -> (B, C, N)."""
    return torch.gather(t_flat, 2, idx.unsqueeze(1).expand(-1, t_flat.shape[1], -1))


def _pixel_columns(s, geom_rows, i0, t_flat, intr, H, W, bilinear,
                   robust_loss="none", delta=None, gain=None):
    """(B, 1) state columns -> (J (B, 6, N), r_w (B, N), validf (B, N),
    depth): each pixel's Jacobian row and residual, scaled by sqrt(w(r))
    under robust_loss at scale delta ((B, 1)), and its valid flag. geom_rows
    are pack_geometry's rows; with six (ESM) the sampled target gradient is
    averaged with the source gradient of rows 4 and 5. depth is None, or
    with gain ((B, 1) depth gains, six-channel t_flat) the bi-objective
    depth rows and residuals (Jd (B, 6, N), rd_w (B, N)), weighted at the
    same delta (phovo_tpu/ops/fused_batch.py:541-563)."""
    fx, fy, cx, cy = intr
    px, py, pz, vd = geom_rows[:4]
    (R00, R01, R02, R10, R11, R12, R20, R21, R22), dY, dP, dR = _rotation_terms(
        s[3], s[4], s[5]
    )
    tx = R00 * px + R01 * py + R02 * pz + s[0]
    ty = R10 * px + R11 * py + R12 * pz + s[1]
    tz = R20 * px + R21 * py + R22 * pz + s[2]
    safe_z = torch.where(torch.abs(tz) > 1e-12, tz, torch.full_like(tz, 1e-12))
    iz = 1.0 / safe_z
    u = tx * fx * iz + cx
    v = ty * fy * iz + cy
    valid = (vd > 0.5) & (tz > 0)

    ry0 = dY[0] * px + dY[1] * py + dY[2] * pz
    ry1 = dY[3] * px + dY[4] * py + dY[5] * pz
    rp0 = dP[0] * px + dP[1] * py + dP[2] * pz
    rp1 = dP[3] * px + dP[4] * py + dP[5] * pz
    rp2 = dP[6] * px + dP[7] * py + dP[8] * pz
    rr0 = dR[0] * py + dR[1] * pz
    rr1 = dR[2] * py + dR[3] * pz
    rr2 = dR[4] * py + dR[5] * pz
    a0 = fx * iz
    a2 = -fx * tx * iz * iz
    b1 = fy * iz
    b2 = -fy * ty * iz * iz
    Ju3 = a0 * ry0
    Ju4 = a0 * rp0 + a2 * rp2
    Ju5 = a0 * rr0 + a2 * rr2
    Jv3 = b1 * ry1
    Jv4 = b1 * rp1 + b2 * rp2
    Jv5 = b1 * rr1 + b2 * rr2

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

    def index(rows, cols):
        # clamp in float, convert, clamp again: NaN converts to an
        # arbitrary integer, and gather must never read out of range
        ri = torch.clamp(rows, 0, H - 1).to(torch.int64).clamp_(0, H - 1)
        ci = torch.clamp(cols, 0, W - 1).to(torch.int64).clamp_(0, W - 1)
        return ri * W + ci

    if bilinear:
        v00 = _sample(t_flat, index(r0, c0))
        v01 = _sample(t_flat, index(r0, c0 + 1))
        v10 = _sample(t_flat, index(r0 + 1, c0))
        v11 = _sample(t_flat, index(r0 + 1, c0 + 1))
        fc3 = fc.unsqueeze(1)
        fr3 = fr.unsqueeze(1)
        top = v00 * (1 - fc3) + v01 * fc3
        bot = v10 * (1 - fc3) + v11 * fc3
        samp = top * (1 - fr3) + bot * fr3
    else:
        samp = _sample(t_flat, index(r0, c0))
    i1w, gxw, gyw, *depth = samp.unbind(1)
    if len(geom_rows) == 6:  # ESM: average with the source gradient
        gxw = 0.5 * (gxw + geom_rows[4])
        gyw = 0.5 * (gyw + geom_rows[5])

    validf = valid.to(torch.float32)
    resid = (i1w - i0) * validf
    if robust_loss == "none":
        scale, r_w = validf, resid
    else:
        scale = validf * sqrt_weight(resid, robust_loss, delta)
        r_w = resid * scale
    J = torch.stack([
        (gxw * a0) * scale,
        (gyw * b1) * scale,
        (gxw * a2 + gyw * b2) * scale,
        (gxw * Ju3 + gyw * Jv3) * scale,
        (gxw * Ju4 + gyw * Jv4) * scale,
        (gxw * Ju5 + gyw * Jv5) * scale,
    ], dim=1)  # (B, 6, N)
    if gain is None:
        return J, r_w, validf, None
    # the depth channel: residual gain (D1(warped) - tz) with the raw tz,
    # row gain (grad D . J_pix - J_rt z-row), z-row [0, 0, 1, 0, rp2, rr2]
    d1w, dgxw, dgyw = depth
    r_dep = gain * (d1w - tz) * validf
    if robust_loss == "none":
        s_dep, rd_w = validf, r_dep
    else:
        s_dep = validf * sqrt_weight(r_dep, robust_loss, delta)
        rd_w = r_dep * s_dep
    Jd = torch.stack([
        gain * (dgxw * a0) * s_dep,
        gain * (dgyw * b1) * s_dep,
        gain * (dgxw * a2 + dgyw * b2 - 1.0) * s_dep,
        gain * (dgxw * Ju3 + dgyw * Jv3) * s_dep,
        gain * (dgxw * Ju4 + dgyw * Jv4 - rp2) * s_dep,
        gain * (dgxw * Ju5 + dgyw * Jv5 - rr2) * s_dep,
    ], dim=1)
    return J, r_w, validf, (Jd, rd_w)


def _linearize(s, geom_rows, i0, t_flat, intr, H, W, bilinear,
               robust_loss="none", delta=None, gain=None):
    """(B, 1) state columns -> (JtJ (B, 6, 6), Jtr (B, 6), cost (B,),
    nvalid (B,)) of every pair at its current state; cost is the weighted
    sum w r^2 under a robust loss. With gain the depth channel's sums are
    taken apart and added to the intensity's (phovo_tpu's order,
    fused_batch.py:572-582); nvalid counts each pixel once."""
    J, r_w, validf, depth = _pixel_columns(
        s, geom_rows, i0, t_flat, intr, H, W, bilinear, robust_loss, delta, gain
    )
    JtJ = torch.bmm(J, J.transpose(1, 2))
    Jtr = torch.bmm(J, r_w.unsqueeze(2)).squeeze(2)
    cost = torch.sum(r_w * r_w, dim=1)
    if depth is not None:
        Jd, rd_w = depth
        JtJ = JtJ + torch.bmm(Jd, Jd.transpose(1, 2))
        Jtr = Jtr + torch.bmm(Jd, rd_w.unsqueeze(2)).squeeze(2)
        cost = cost + torch.sum(rd_w * rd_w, dim=1)
    return JtJ, Jtr, cost, torch.sum(validf, dim=1)


def _chol_solve6(A, b):
    """Unrolled 6x6 Cholesky solve of A x = b, batched over pairs (entries
    are (B,) tensors); rsqrt pivots floored at 1e-30 with NaN kept, as
    phovo_tpu/ops/fused.py::_chol_solve6 and the CUDA kernel do."""
    L = [[None] * 6 for _ in range(6)]
    inv_diag = [None] * 6
    for i in range(6):
        acc = A[:, i, i]
        for k in range(i):
            acc = acc - L[i][k] * L[i][k]
        acc = torch.clamp(acc, min=1e-30)
        inv_d = torch.rsqrt(acc)
        L[i][i] = acc * inv_d
        inv_diag[i] = inv_d
        for j in range(i + 1, 6):
            acc = A[:, j, i]
            for k in range(i):
                acc = acc - L[j][k] * L[i][k]
            L[j][i] = acc * inv_d
    ys = [None] * 6
    for i in range(6):
        acc = b[:, i]
        for k in range(i):
            acc = acc - L[i][k] * ys[k]
        ys[i] = acc * inv_diag[i]
    xs = [None] * 6
    for i in range(5, -1, -1):
        acc = ys[i]
        for k in range(i + 1, 6):
            acc = acc - L[k][i] * xs[k]
        xs[i] = acc * inv_diag[i]
    return xs


def fused_gn_level_batch_reference(
    i0: torch.Tensor,
    geom: torch.Tensor,
    t_all: torch.Tensor,
    intr: Intrinsics,
    init_states: torch.Tensor,
    max_iterations: int,
    min_gradient_norm: float,
    lambda_step: float,
    *,
    H: int,
    W: int,
    sampling: str = "nearest",
    robust_loss: str = "none",
    robust_delta: float = 0.1,
    esm: bool = False,
    robust_scale: torch.Tensor | None = None,
    tdist_burnin: int = 0,
    depth_gains: torch.Tensor | None = None,
) -> LevelBatchResult:
    """Plain batched torch version of fused_gn_level_batch, on any device.
    A Python while loop over iterations runs until every pair froze; a
    frozen pair's state, diagnostics and scale stop changing."""
    shared = _check_inputs(i0, geom, t_all, init_states, H, W, sampling, esm, robust_loss, robust_scale,
                           depth_gains)
    B = t_all.shape[0]
    if shared:
        i0, geom = _shared_views(i0, geom, B)
    rows = geom.unbind(1)
    t_flat = t_all.reshape(B, t_all.shape[1], H * W)
    gain = None if depth_gains is None else depth_gains.unsqueeze(1)
    s = [init_states[:, k] for k in range(6)]
    zero = torch.zeros(B, dtype=torch.float32, device=i0.device)
    it, gnorm = zero, torch.full_like(zero, float("inf"))
    cost, nvalid = zero, zero
    sigma = _scales(robust_delta, robust_scale, B, i0.device)
    tdist = robust_loss == "tdist"

    def linearize(s, sigma):
        return _linearize(
            [c.unsqueeze(1) for c in s], rows, i0, t_flat, intr, H, W,
            sampling == "bilinear", robust_loss, sigma.unsqueeze(1), gain,
        )

    if tdist and max_iterations > 0:
        for _ in range(tdist_burnin):  # scale-only passes at the initial state
            _, _, cost_b, nvalid_b = linearize(s, sigma)
            sigma = tdist_scale_update(cost_b, nvalid_b)
    while True:
        act = (it < max_iterations) & (gnorm >= min_gradient_norm)
        if not bool(act.any()):
            break
        JtJ, Jtr, cost_i, nvalid_i = linearize(s, sigma)
        xs = _chol_solve6(JtJ, Jtr)
        finite = torch.stack([torch.isfinite(x) for x in xs]).all(dim=0)
        upd = act & finite
        s = [torch.where(upd, s[k] - lambda_step * xs[k], s[k]) for k in range(6)]
        g2 = Jtr[:, 0] * Jtr[:, 0]
        for k in range(1, 6):
            g2 = g2 + Jtr[:, k] * Jtr[:, k]
        it = it + act.to(torch.float32)
        gnorm = torch.where(act, torch.sqrt(g2), gnorm)
        cost = torch.where(act, cost_i, cost)
        nvalid = torch.where(act, nvalid_i, nvalid)
        if tdist:
            sigma = torch.where(act, tdist_scale_update(cost_i, nvalid_i), sigma)
    return LevelBatchResult(
        torch.stack(s, dim=1),
        it.to(torch.int32),
        torch.where(torch.isfinite(gnorm), gnorm, zero),
        cost,
        nvalid,
        zero,
        sigma,
    )


def _check_tr_variant(geom, t_all, robust_loss):
    """Raise ValueError on what the trust-region kernel has no variant for,
    as phovo_tpu's has none: the Student-t loss, ESM geometry and the
    bi-objective six-channel target."""
    if robust_loss == "tdist":
        raise ValueError(
            "robust_loss='tdist' has no trust-region kernel: its adaptive "
            "scale changes the cost between iterations, which breaks the "
            "accept/reject comparison; use the Gauss-Newton level"
        )
    if isinstance(geom, torch.Tensor) and geom.dim() == 3 and geom.shape[1] == 6:
        raise ValueError(
            "the trust-region level has no ESM, as phovo_tpu's has none: six "
            "geometry rows (gradient_at='esm') are refused; the ceres "
            "backend packs four rows whatever gradient_at says and samples "
            "the target gradient at the warped point"
        )
    if isinstance(t_all, torch.Tensor) and t_all.dim() == 4 and t_all.shape[1] == 6:
        raise ValueError(
            "the trust-region level is photometric (phovo_tpu's has no "
            "bi-objective mode): a six-channel target is refused; the "
            "bi-objective backend runs the Gauss-Newton level"
        )


def fused_tr_level_batch(
    i0: torch.Tensor,  # (B | 1, H*W) source intensities (1: shared)
    geom: torch.Tensor,  # (B | 1, 4, H*W) pack_geometry rows
    t_all: torch.Tensor,  # (B, 3, H, W) pack_target stacks
    intr: Intrinsics,  # at this level
    init_states: torch.Tensor,  # (B, 6)
    opts,  # solvers.trust_region.TROptions
    *,
    H: int,
    W: int,
    sampling: str = "bilinear",
    robust_loss: str = "none",
    robust_delta: float = 0.1,
) -> TRLevelBatchResult:
    """Run ONE whole trust-region LM level for B independent pairs: the
    CUDA kernel for CUDA tensors, the plain torch version for CPU tensors.
    Any other device raises; so does a failed build or launch (there is no
    fallback). Every option goes to the kernel as a float32 scalar.
    robust_loss huber, cauchy or tukey weights every pixel at scale
    robust_delta, and the costs are then weighted sums; 'tdist' raises
    ValueError. A shared source pack (i0 (1, N), geom (1, 4, N), B taken
    from t_all: keyframe tracking) gives the bits of the same pack repeated
    B times."""
    global TR_LAUNCHES, TR_SHARED_LAUNCHES
    with profiling.span("phovo.level"):
        if i0.device.type == "cpu":
            return fused_tr_level_batch_reference(
                i0, geom, t_all, intr, init_states, opts, H=H, W=W, sampling=sampling,
                robust_loss=robust_loss, robust_delta=robust_delta,
            )
        _check_tr_variant(geom, t_all, robust_loss)
        shared = _check_inputs(i0, geom, t_all, init_states, H, W, sampling, robust_loss=robust_loss)
        if i0.device.type != "cuda":
            raise ValueError(f"no level kernel for device {i0.device}")

        from phovo_tpu_torch.ops import _build

        lib = _build.library()
        with torch.cuda.device(i0.device):
            args, (states, diag) = _tr_launch_args(
                i0, geom, t_all, intr, init_states, opts, H=H, W=W, shared=shared,
                sampling=sampling, robust_loss=robust_loss, robust_delta=robust_delta,
                stream=torch.cuda.current_stream(i0.device).cuda_stream,
            )
            if t_all.shape[0]:
                _raise_on_launch_error("fused_tr_batch", lib.phovo_fused_tr_level_batch(*args), t_all.shape[0], H, W)
                TR_LAUNCHES += 1
                TR_SHARED_LAUNCHES += shared
        return TRLevelBatchResult(
            states, diag[:, 0].to(torch.int32), diag[:, 2], diag[:, 1],
            diag[:, 4], diag[:, 3], diag[:, 5],
        )


def _tr_launch_args(i0, geom, t_all, intr, init_states, opts, *, H, W,
                    shared=None, sampling="bilinear", robust_loss="none",
                    robust_delta=0.1, stream=0, cluster=None):
    """phovo_fused_tr_level_batch's arguments in its order
    (csrc/fused_tr_batch.cu), from fused_tr_level_batch's arguments, with
    the tensors they point at: (args, (states_out, diag_out)). shared and
    cluster as in _gn_launch_args."""
    if shared is None:
        shared = _check_inputs(i0, geom, t_all, init_states, H, W, sampling, robust_loss=robust_loss)
    B = t_all.shape[0]
    states = torch.empty((B, 6), dtype=torch.float32, device=i0.device)
    diag = torch.empty((B, 6), dtype=torch.float32, device=i0.device)
    args = (
        i0.data_ptr(), geom.data_ptr(), t_all.data_ptr(), init_states.data_ptr(),
        states.data_ptr(), diag.data_ptr(), B, H, W, int(sampling == "bilinear"),
        _LOSS_CODES[robust_loss], int(shared),
        cluster_size(H, W) if cluster is None else int(cluster), float(robust_delta),
        intr.fx, intr.fy, intr.cx, intr.cy, int(opts.max_iterations), *_tr_scalars(opts),
        stream,
    )
    return args, (states, diag)


def _tr_scalars(opts) -> tuple[float, ...]:
    """The float options in the kernel's argument order."""
    return tuple(float(v) for v in (
        opts.function_tolerance, opts.gradient_tolerance,
        opts.parameter_tolerance, opts.initial_trust_region_radius,
        opts.max_trust_region_radius, opts.min_trust_region_radius,
        opts.min_relative_decrease,
    ))


def fused_tr_level_batch_reference(
    i0: torch.Tensor,
    geom: torch.Tensor,
    t_all: torch.Tensor,
    intr: Intrinsics,
    init_states: torch.Tensor,
    opts,
    *,
    H: int,
    W: int,
    sampling: str = "bilinear",
    robust_loss: str = "none",
    robust_delta: float = 0.1,
) -> TRLevelBatchResult:
    """Plain batched torch version of fused_tr_level_batch, on any device,
    in the TPU kernel's order of operations (phovo_tpu/ops/fused_batch.py::
    _fused_tr_batch_kernel). The options are float32 tensors, so the radius,
    rho and the tolerances compare in float32 as the kernels compare them.
    A Python while loop over iterations runs until every pair froze; a
    frozen pair's state and diagnostics stop changing."""
    _check_tr_variant(geom, t_all, robust_loss)
    shared = _check_inputs(i0, geom, t_all, init_states, H, W, sampling, robust_loss=robust_loss)
    B = t_all.shape[0]
    if shared:
        i0, geom = _shared_views(i0, geom, B)
    rows = geom.unbind(1)
    t_flat = t_all.reshape(B, 3, H * W)
    delta = _scales(robust_delta, None, B, i0.device).unsqueeze(1)
    ftol, gtol, ptol, radius0, rmax, rmin, mrd = (
        torch.tensor(v, dtype=torch.float32, device=i0.device)
        for v in _tr_scalars(opts)
    )
    one_third = torch.tensor(1.0 / 3.0, dtype=torch.float32, device=i0.device)
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=i0.device)

    def linearize(s):
        return _linearize(
            [s[:, k:k + 1] for k in range(6)], rows, i0, t_flat, intr, H, W,
            sampling == "bilinear", robust_loss, delta,
        )

    def dot6(a, b):
        acc = a[:, 0] * b[:, 0]
        for k in range(1, 6):
            acc = acc + a[:, k] * b[:, k]
        return acc

    state = init_states
    JtJ, Jtr, cost_raw, nvalid = linearize(state)
    it = torch.zeros(B, dtype=torch.float32, device=i0.device)
    radius = radius0.expand(B)
    done = Jtr.abs().amax(dim=1) <= gtol
    while True:
        act = (it < opts.max_iterations) & ~done
        if not bool(act.any()):
            break
        cost = 0.5 * cost_raw
        d = torch.diagonal(JtJ, dim1=1, dim2=2)
        A_lm = JtJ + torch.diag_embed(torch.clamp(d, 1e-12, 1e32) * (1.0 / radius)[:, None])
        step = torch.stack(_chol_solve6(A_lm, -Jtr), dim=1)
        step = torch.where(torch.isfinite(step).all(dim=1, keepdim=True), step, 0.0)
        trial = state + step
        JtJ_n, Jtr_n, cost_n_raw, nvalid_n = linearize(trial)
        new_cost = 0.5 * cost_n_raw

        sAs = torch.zeros_like(cost)
        for i in range(6):
            for j in range(6):
                sAs = sAs + step[:, i] * JtJ[:, i, j] * step[:, j]
        predicted = torch.maximum(-dot6(step, Jtr) - 0.5 * sAs, tiny)
        rho = (cost - new_cost) / predicted
        accept = rho > mrd
        t = 2.0 * rho - 1.0
        grow = radius / torch.maximum(one_third, 1.0 - t * (t * t))
        new_radius = torch.where(accept, torch.minimum(grow, rmax), radius * 0.5)

        x2, s2 = dot6(state, state), dot6(step, step)
        upd = act & accept
        state = torch.where(upd[:, None], trial, state)
        JtJ = torch.where(upd[:, None, None], JtJ_n, JtJ)
        Jtr = torch.where(upd[:, None], Jtr_n, Jtr)
        cost_raw = torch.where(upd, cost_n_raw, cost_raw)
        nvalid = torch.where(upd, nvalid_n, nvalid)

        f_done = accept & (torch.abs(cost - new_cost) <= ftol * cost)
        g_done = Jtr.abs().amax(dim=1) <= gtol
        p_done = accept & (torch.sqrt(s2) <= ptol * (torch.sqrt(x2) + ptol))
        r_done = new_radius < rmin
        done = torch.where(act, f_done | g_done | p_done | r_done, done)
        radius = torch.where(act, new_radius, radius)
        it = it + act.to(torch.float32)
    return TRLevelBatchResult(
        state, it.to(torch.int32), 0.5 * cost_raw, Jtr.abs().amax(dim=1),
        radius, nvalid, torch.zeros_like(it),
    )


def _check_lin_inputs(*args):
    """_check_inputs for the one-linearization kernel, which takes one
    source per pair."""
    if _check_inputs(*args):
        raise ValueError("the one-linearization kernel takes one source pack per pair, not a shared one")


def lin_split(H: int, W: int) -> int:
    """Blocks K-LIN spreads one pair's H x W linearization over: about
    2,400 pixels a block, a power of two (30x40: 1, 60x80: 2, 120x160: 8,
    240x320: 32, 480x640: 128), so a lone 480x640 pair fills the card. The
    order of the Gram's pixel sums depends on it, so it is a function of
    the level's shape alone, never of B: a pair gives the same bits alone
    and in a batch."""
    # Chosen from timing G = 1 to 512 at every VGA level, B = 1, 16 and
    # 256, both samplings (tools/ktr_ab.py --sweep --kernels lin; PERF.md
    # has the sweeps): far below ~2,400 pixels a block the second launch
    # and the partials cost more than the extra SMs give at large B; far
    # above it a lone pair leaves SMs idle.
    split = 1
    while split * 2_400 < H * W:
        split *= 2
    return split


def _lin_launch_args(i0, geom, t_all, intr, states, *, H, W, sampling="nearest", robust_loss="none",
                     robust_delta=0.1, esm=False, robust_scale=None, stream=0, split=None, partials=None):
    """phovo_fused_lin's arguments in its order (csrc/fused_lin.cu), from
    fused_lin_batch's arguments, with the tensors they point at: (args,
    (gram_out, partials, scale_in)). split defaults to lin_split(H, W);
    another value forces a layout through the C entry (the card tests and
    the sweep). partials is the (B, G, 35) float32 scratch of the split
    layout, allocated here unless given; the C entry refuses one that is
    too small."""
    B = i0.shape[0]
    G = lin_split(H, W) if split is None else int(split)
    scale_in = _scales(robust_delta, robust_scale, B, i0.device)
    gram = torch.empty((B, 8, 8), dtype=torch.float32, device=i0.device)
    if partials is None:
        n = B * G * _GRAM_SUMS if G > 1 else 0
        partials = torch.empty((n,), dtype=torch.float32, device=i0.device)
    args = (
        i0.data_ptr(), geom.data_ptr(), t_all.data_ptr(), states.data_ptr(),
        scale_in.data_ptr(), partials.data_ptr() if partials.numel() else None, partials.numel(),
        gram.data_ptr(), B, H, W, int(sampling == "bilinear"), _LOSS_CODES[robust_loss], int(esm), G,
        intr.fx, intr.fy, intr.cx, intr.cy, stream,
    )
    return args, (gram, partials, scale_in)


def fused_lin_batch(
    i0: torch.Tensor,  # (B, H*W) source intensities
    geom: torch.Tensor,  # (B, 4 | 6, H*W) pack_geometry rows (6 with ESM)
    t_all: torch.Tensor,  # (B, 3, H, W) pack_target stacks
    intr: Intrinsics,  # at this level
    states: torch.Tensor,  # (B, 6)
    *,
    H: int,
    W: int,
    sampling: str = "nearest",
    robust_loss: str = "none",
    robust_delta: float = 0.1,
    esm: bool = False,
    robust_scale: torch.Tensor | None = None,  # (B,) tdist sigma
) -> torch.Tensor:
    """ONE linearization of B pairs at their states: (B, 8, 8) Gram of the
    per-pixel rows [J0..J5, r_w, valid] (phovo_tpu/ops/fused.py::
    _fused_kernel), with slot (6, 7) and (7, 6) holding the band-masked
    pixel count, always 0 here. The CUDA kernel for CUDA tensors (each pair
    over lin_split(H, W) blocks), the plain torch version for CPU tensors;
    any other device, a failed build or launch raises. The loss's scale is
    robust_scale per pair when given (the carried Student-t sigma), else
    robust_delta."""
    global LIN_LAUNCHES
    if i0.device.type == "cpu":
        return fused_lin_batch_reference(
            i0, geom, t_all, intr, states, H=H, W=W, sampling=sampling,
            robust_loss=robust_loss, robust_delta=robust_delta, esm=esm,
            robust_scale=robust_scale,
        )
    _check_lin_inputs(i0, geom, t_all, states, H, W, sampling, esm, robust_loss, robust_scale)
    if i0.device.type != "cuda":
        raise ValueError(f"no level kernel for device {i0.device}")

    from phovo_tpu_torch.ops import _build

    lib = _build.library()
    with torch.cuda.device(i0.device):
        args, (gram, _, _) = _lin_launch_args(
            i0, geom, t_all, intr, states, H=H, W=W, sampling=sampling, robust_loss=robust_loss,
            robust_delta=robust_delta, esm=esm, robust_scale=robust_scale,
            stream=torch.cuda.current_stream(i0.device).cuda_stream,
        )
        if i0.shape[0]:
            err = lib.phovo_fused_lin(*args)
            if err:
                raise RuntimeError(
                    f"fused_lin kernel launch failed: CUDA error {err} (B = {i0.shape[0]} pairs, {H}x{W}, "
                    f"{lin_split(H, W)} blocks a pair by the rule)"
                )
            LIN_LAUNCHES += 1
    return gram


def fused_lin_batch_reference(
    i0: torch.Tensor,
    geom: torch.Tensor,
    t_all: torch.Tensor,
    intr: Intrinsics,
    states: torch.Tensor,
    *,
    H: int,
    W: int,
    sampling: str = "nearest",
    robust_loss: str = "none",
    robust_delta: float = 0.1,
    esm: bool = False,
    robust_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain torch version of fused_lin_batch, on any device: one batched
    matrix product of the stacked rows."""
    _check_lin_inputs(i0, geom, t_all, states, H, W, sampling, esm, robust_loss, robust_scale)
    B = i0.shape[0]
    sigma = _scales(robust_delta, robust_scale, B, i0.device).unsqueeze(1)
    J, r_w, validf, _ = _pixel_columns(
        [states[:, k:k + 1] for k in range(6)], geom.unbind(1), i0,
        t_all.reshape(B, 3, H * W), intr, H, W, sampling == "bilinear",
        robust_loss, sigma,
    )
    G = torch.cat([J, r_w.unsqueeze(1), validf.unsqueeze(1)], dim=1)  # (B, 8, N)
    gram = torch.bmm(G, G.transpose(1, 2))
    gram[:, 6, 7] = 0.0  # band_masked: the whole target is sampled
    gram[:, 7, 6] = 0.0
    return gram
