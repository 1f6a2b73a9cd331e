"""Per-frame packs for the level kernels (torch port of the pack helpers in
phovo_tpu/ops/fused.py), the per-pair Gauss-Newton (photometric and
bi-objective) and trust-region levels (the batched kernels at B = 1), the
multi-stream level (the batched Gauss-Newton kernel at B = S), the
per-linearization API over the one-linearization kernel, and the
normal-equation dispatch.

The packs hoist everything state-invariant out of the Gauss-Newton loop:
the back-projected source points with their depth-range mask, and the
target's intensity and gradients stacked so one pixel's three samples sit
at one (row, col) offset. The port computes at the exact pixel count
(N = H*W): the 128-lane padding and ceil8 row padding of the TPU layout
have no use on the GPU.
"""

from __future__ import annotations

import torch

from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.fused_batch import (
    LevelBatchResult,
    fused_gn_level_batch,
    fused_gn_level_batch_reference,
    fused_lin_batch,
    fused_tr_level_batch,
)
from phovo_tpu_torch.ops.residuals import (
    NormalEquations,
    normal_equations,
    photometric_residual_jacobian,
)
from phovo_tpu_torch.utils import profiling


def pack_geometry(
    source_depth: torch.Tensor,  # (..., H, W) metres
    intr: Intrinsics,
    min_depth: float,
    max_depth: float,
    source_grads=None,  # (gx0, gy0), each (..., H, W): the ESM rows
) -> torch.Tensor:
    """(..., 4, H*W) rows [px, py, pz, valid_depth]: the back-projected
    source point and the open (min_depth, max_depth) range mask. With
    source_grads, the source intensity gradients of the ESM Jacobian
    (gradient_at='esm') follow as rows 4 and 5: (..., 6, H*W)."""
    H, W = source_depth.shape[-2:]
    with profiling.span("phovo.prep"):
        c = torch.arange(W, dtype=torch.float32, device=source_depth.device)
        r = torch.arange(H, dtype=torch.float32, device=source_depth.device)
        rr, cc = torch.meshgrid(r, c, indexing="ij")
        px = (cc - intr.cx) * source_depth / intr.fx
        py = (rr - intr.cy) * source_depth / intr.fy
        valid = ((source_depth > min_depth) & (source_depth < max_depth)).to(torch.float32)
        rows = [px, py, source_depth, valid]
        if source_grads is not None:
            rows += list(source_grads)
        geom = torch.stack(rows, dim=-3)
    return geom.reshape(*geom.shape[:-2], H * W)


def pack_target(
    target_intensity: torch.Tensor,
    target_grad_x: torch.Tensor,
    target_grad_y: torch.Tensor,
    depth_cols=None,  # (depth, depth_grad_x, depth_grad_y): the bi-objective level
) -> torch.Tensor:
    """(..., 3, H, W) channel stack [I, gx, gy] of one target frame; with
    depth_cols the bi-objective (..., 6, H, W) stack [I, gx, gy, D, dgx,
    dgy] (phovo_tpu's fused_gn_level depth_cols layout)."""
    return torch.stack(
        [target_intensity, target_grad_x, target_grad_y, *(depth_cols or ())], dim=-3
    )


def fused_tr_level(
    source_intensity: torch.Tensor,  # (H, W)
    source_depth: torch.Tensor,  # (H, W) metres
    t_all: torch.Tensor,  # (3, H, W) pack_target of the target frame
    intr: Intrinsics,  # at this level
    init_state: torch.Tensor,  # (6,)
    min_depth: float,
    max_depth: float,
    opts,  # solvers.trust_region.TROptions
    sampling: str = "bilinear",
    robust_loss: str = "none",
    robust_delta: float = 0.1,
):
    """One whole trust-region LM level for one pair (torch port of
    phovo_tpu/ops/fused.py::fused_tr_level): the pair is packed and run
    through the batched level (ops/fused_batch.fused_tr_level_batch) with
    B = 1, the CUDA kernel for CUDA tensors and its plain version for CPU
    tensors. Returns (state (6,), iterations, cost, gradient_norm, radius,
    num_valid, band_masked) in solvers.trust_region.TRLevelResult's order."""
    H, W = source_intensity.shape
    res = fused_tr_level_batch(
        source_intensity.reshape(1, H * W).contiguous(),
        pack_geometry(source_depth, intr, min_depth, max_depth)[None].contiguous(),
        t_all[None].contiguous(),
        intr,
        init_state.to(torch.float32).reshape(1, 6).contiguous(),
        opts, H=H, W=W, sampling=sampling, robust_loss=robust_loss,
        robust_delta=robust_delta,
    )
    return tuple(x[0] for x in res)


def fused_gn_level_packs(
    i0_flat: torch.Tensor,  # (H*W,) or (1, H*W) source intensity
    geom: torch.Tensor,  # (4 | 6, H*W) pack_geometry rows (6 with ESM)
    t_all: torch.Tensor,  # (3 | 6, H, W) pack_target of the target frame
    intr: Intrinsics,  # at this level
    init_state: torch.Tensor,  # (6,)
    max_iterations: int,
    min_gradient_norm: float,
    lambda_step: float,
    *,
    H: int,
    W: int,
    sampling: str = "nearest",
    bi: bool = False,
    depth_gain=None,  # bi: mean(I1) / mean(D1) of the target level
    robust_loss: str = "none",
    robust_delta: float = 0.1,
    esm: bool = False,
    robust_scale=None,  # tdist: the sigma carried from the level before
    tdist_burnin: int = 0,
):
    """One whole Gauss-Newton level for one pair on pre-packed inputs
    (torch port of phovo_tpu/ops/fused.py::fused_gn_level_packs): the
    batched level (ops/fused_batch.fused_gn_level_batch) with B = 1, the
    CUDA kernel for CUDA tensors and its plain version for CPU tensors.
    robust_scale defaults to robust_delta. bi runs the bi-objective level
    (phovo_tpu's _fused_gn_bi_kernel, K-GN-bi at B = 1) on the six-channel
    t_all with depth_gain. Returns (state (6,), iterations, gradient_norm,
    cost, num_valid, band_masked, robust_scale), the last the final
    Student-t sigma for 'tdist'."""

    def pair_scalar(x):
        return torch.as_tensor(x, dtype=torch.float32, device=i0_flat.device).reshape(1)

    scale = None if robust_scale is None else pair_scalar(robust_scale)
    gains = None
    if bi:
        if depth_gain is None:
            raise ValueError("the bi-objective level needs depth_gain")
        gains = pair_scalar(depth_gain)
    res = fused_gn_level_batch(
        i0_flat.reshape(1, H * W).contiguous(),
        geom[None].contiguous(),
        t_all[None].contiguous(),
        intr,
        init_state.to(device=i0_flat.device, dtype=torch.float32).reshape(1, 6).contiguous(),
        max_iterations, min_gradient_norm, lambda_step, H=H, W=W,
        sampling=sampling, robust_loss=robust_loss, robust_delta=robust_delta,
        esm=esm, robust_scale=scale, tdist_burnin=tdist_burnin, depth_gains=gains,
    )
    return tuple(x[0] for x in res)


def fused_gn_level(
    source_intensity: torch.Tensor,  # (H, W)
    source_depth: torch.Tensor,  # (H, W) metres
    tgt_cols: torch.Tensor,  # (3, H, W) pack_target of the target frame
    intr: Intrinsics,  # at this level
    init_state: torch.Tensor,  # (6,)
    min_depth: float,
    max_depth: float,
    max_iterations: int,
    min_gradient_norm: float,
    lambda_step: float,
    sampling: str = "nearest",
    depth_cols=None,  # (depth, depth_grad_x, depth_grad_y) of the target
    depth_gain=None,
    robust_loss: str = "none",
    robust_delta: float = 0.1,
    source_grads=None,  # (gx0, gy0): the ESM Jacobian
    robust_scale=None,
    tdist_burnin: int = 0,
):
    """One whole Gauss-Newton level for one pair (torch port of
    phovo_tpu/ops/fused.py::fused_gn_level): packs the source and runs
    fused_gn_level_packs. depth_cols with depth_gain switch to the
    bi-objective (intensity + depth) level on the six-channel stack;
    there ESM and the Student-t loss raise ValueError, as in phovo_tpu."""
    bi = depth_cols is not None
    if bi:
        if source_grads is not None:
            raise ValueError("gradient_at='esm' is photometric-only")
        if robust_loss == "tdist":
            raise ValueError(
                "robust_loss='tdist' is photometric-only (the intensity and "
                "depth channels would need separate adaptive scales); use "
                "huber/cauchy/tukey for the bi-objective backend"
            )
        tgt_cols = torch.cat([tgt_cols, torch.stack(list(depth_cols))])
    H, W = source_intensity.shape
    return fused_gn_level_packs(
        source_intensity.reshape(H * W),
        pack_geometry(source_depth, intr, min_depth, max_depth, source_grads),
        tgt_cols, intr, init_state, max_iterations, min_gradient_norm,
        lambda_step, H=H, W=W, sampling=sampling, bi=bi, depth_gain=depth_gain,
        robust_loss=robust_loss, robust_delta=robust_delta,
        esm=source_grads is not None, robust_scale=robust_scale,
        tdist_burnin=tdist_burnin,
    )


# Launches of the multi-stream level (phovo_tpu's B7 route) in this
# process: one per fused_gn_level_multi[_packs] call on CUDA tensors, which
# is one launch of the batched Gauss-Newton kernel (counted in
# fused_batch.LAUNCHES too). Reset it to 0 before a run, read it after.
MULTI_LAUNCHES = 0


def _check_multi_loss(robust_loss: str) -> None:
    if robust_loss == "tdist":
        raise ValueError(
            "robust_loss='tdist' has no multi-stream level (phovo_tpu's "
            "multi_kernel_eligible excludes it); align the streams with "
            "parallel.batch.align_batch"
        )


def fused_gn_level_multi_packs(i0, geom, t_all, *args, robust_loss: str = "none", **kwargs) -> LevelBatchResult:
    """The multi-stream level on pre-packed streams: fused_gn_level_batch's
    arguments (i0 (S, N), geom (S, 4 | 6, N), t_all (S, 3, H, W), ...),
    one launch of the batched Gauss-Newton kernel for the S streams on
    CUDA tensors (counted in MULTI_LAUNCHES), its plain version on CPU
    tensors. 'tdist' raises ValueError."""
    global MULTI_LAUNCHES
    _check_multi_loss(robust_loss)
    res = fused_gn_level_batch(i0, geom, t_all, *args, robust_loss=robust_loss, **kwargs)
    if i0.device.type != "cpu" and i0.shape[0]:
        MULTI_LAUNCHES += 1
    return res


def _multi_packs(source_intensity, source_depth, tgt_cols, intr, init_states,
                 min_depth, max_depth, source_grads):
    """The S streams' packs for the batched level: i0 (S, N), geom (S, 4 |
    6, N), t_all (S, 3, H, W), states (S, 6)."""
    S, H, W = source_intensity.shape
    return (
        source_intensity.reshape(S, H * W).contiguous(),
        pack_geometry(source_depth, intr, min_depth, max_depth, source_grads).contiguous(),
        tgt_cols.reshape(S, 3, H, W).contiguous(),
        init_states.to(device=source_intensity.device, dtype=torch.float32).reshape(S, 6).contiguous(),
    )


def fused_gn_level_multi(
    source_intensity: torch.Tensor,  # (S, H, W)
    source_depth: torch.Tensor,  # (S, H, W) metres
    tgt_cols: torch.Tensor,  # (S, 3H, W) channel-major stacks [I; gx; gy]
    intr: Intrinsics,  # at this level, shared by the streams
    init_states: torch.Tensor,  # (S, 6)
    min_depth: float,
    max_depth: float,
    max_iterations: int,
    min_gradient_norm: float,
    lambda_step: float,
    sampling: str = "nearest",
    robust_loss: str = "none",
    robust_delta: float = 0.1,
    source_grads=None,  # (gx0, gy0) each (S, H, W): the ESM Jacobian
) -> LevelBatchResult:
    """ONE whole Gauss-Newton level for S independent streams (torch port of
    phovo_tpu/ops/fused.py::fused_gn_level_multi, its kernel
    _fused_gn_multi_kernel): each stream is packed and the S pairs run in
    one launch of the batched Gauss-Newton kernel (fused_gn_level_multi_packs
    over ops/fused_batch.fused_gn_level_batch), whose per-pair loop freezes
    each stream on ||J^T r|| or its budget exactly as the TPU kernel's
    masked updates do (phovo_tpu/ops/fused.py:1465-1504). The TPU kernel
    exists to keep S streams VMEM-resident and the MXU pipelined across
    them; one block per stream is the Hopper form of the same work, so no
    other device code computes it. CPU tensors run the plain version.
    'none', huber, cauchy and tukey, with or without ESM; 'tdist' raises
    ValueError. Returns the level's LevelBatchResult (band_masked 0)."""
    _check_multi_loss(robust_loss)
    S, H, W = source_intensity.shape
    i0, geom, t_all, states = _multi_packs(source_intensity, source_depth, tgt_cols, intr, init_states,
                                           min_depth, max_depth, source_grads)
    return fused_gn_level_multi_packs(
        i0, geom, t_all, intr, states, max_iterations, min_gradient_norm, lambda_step,
        H=H, W=W, sampling=sampling, robust_loss=robust_loss,
        robust_delta=robust_delta, esm=source_grads is not None,
    )


def fused_gn_level_multi_reference(
    source_intensity, source_depth, tgt_cols, intr, init_states, min_depth,
    max_depth, max_iterations, min_gradient_norm, lambda_step,
    sampling="nearest", robust_loss="none", robust_delta=0.1, source_grads=None,
) -> LevelBatchResult:
    """Plain version of fused_gn_level_multi on any device: the same packs
    through fused_batch.fused_gn_level_batch_reference."""
    _check_multi_loss(robust_loss)
    S, H, W = source_intensity.shape
    i0, geom, t_all, states = _multi_packs(source_intensity, source_depth, tgt_cols, intr, init_states,
                                           min_depth, max_depth, source_grads)
    return fused_gn_level_batch_reference(
        i0, geom, t_all, intr, states, max_iterations, min_gradient_norm, lambda_step,
        H=H, W=W, sampling=sampling, robust_loss=robust_loss,
        robust_delta=robust_delta, esm=source_grads is not None,
    )


def make_fused_linearizer(
    source_intensity: torch.Tensor,  # (H, W)
    source_depth: torch.Tensor,  # (H, W) metres
    tgt_cols: torch.Tensor,  # (3, H, W) pack_target of the target frame
    intr: Intrinsics,
    min_depth: float,
    max_depth: float,
    sampling: str = "nearest",
    robust_loss: str = "none",
    robust_delta: float = 0.1,
    source_grads=None,  # (gx0, gy0): the ESM Jacobian
):
    """linearize(state, robust_scale=None) -> NormalEquations, with the
    packs built once (torch port of phovo_tpu/ops/fused.py::
    make_fused_linearizer): each call is one launch of the
    one-linearization kernel (ops/fused_batch.fused_lin_batch) at B = 1 on
    CUDA tensors, its plain version on CPU tensors. robust_scale is the
    loss's scale for this call (the solver's carried Student-t sigma);
    robust_delta when None."""
    H, W = source_intensity.shape
    device = source_intensity.device
    i0 = source_intensity.reshape(1, H * W).contiguous()
    geom = pack_geometry(source_depth, intr, min_depth, max_depth, source_grads)[None].contiguous()
    t_all = tgt_cols[None].contiguous()

    def linearize(state, robust_scale=None) -> NormalEquations:
        scale = None
        if robust_scale is not None:
            scale = torch.as_tensor(robust_scale, dtype=torch.float32, device=device).reshape(1)
        gram = fused_lin_batch(
            i0, geom, t_all, intr,
            state.to(device=device, dtype=torch.float32).reshape(1, 6).contiguous(),
            H=H, W=W, sampling=sampling, robust_loss=robust_loss,
            robust_delta=robust_delta, esm=source_grads is not None,
            robust_scale=scale,
        )[0]
        return NormalEquations(
            gram[:6, :6], gram[:6, 6], gram[6, 6], gram[7, 7], gram[6, 7],
        )

    return linearize


def fused_normal_equations_pallas(
    source_intensity: torch.Tensor,
    source_depth: torch.Tensor,
    tgt_cols: torch.Tensor,  # (3, H, W) pack_target of the target frame
    state: torch.Tensor,
    intr: Intrinsics,
    min_depth: float,
    max_depth: float,
    sampling: str = "nearest",
    robust_loss: str = "none",
    robust_delta: float = 0.1,
    source_grads=None,
) -> NormalEquations:
    """One linearization through the one-linearization kernel (phovo_tpu's
    name for its Pallas route, kept for the callers)."""
    return make_fused_linearizer(
        source_intensity, source_depth, tgt_cols, intr, min_depth, max_depth,
        sampling, robust_loss, robust_delta, source_grads,
    )(state)


def fused_normal_equations(
    source_intensity: torch.Tensor,
    source_depth: torch.Tensor,
    target_intensity: torch.Tensor,
    target_grad_x: torch.Tensor,
    target_grad_y: torch.Tensor,
    state: torch.Tensor,
    intr: Intrinsics,
    min_depth: float = 0.3,
    max_depth: float = 5.0,
    sampling: str = "nearest",
    gradient_at: str = "warped",
    robust_loss: str = "none",
    robust_delta: float = 0.1,
    source_grads=None,
) -> NormalEquations:
    """Normal equations of one linearization, dispatched as phovo_tpu
    dispatches (phovo_tpu/ops/fused.py::fused_normal_equations):
    gradient_at='source' runs the exact torch path; 'warped' and 'esm'
    (with source_grads) the one-linearization kernel, at every level size
    (the GPU has no height cap)."""
    if gradient_at not in ("warped", "esm"):
        r, J, valid = photometric_residual_jacobian(
            source_intensity, source_depth, target_intensity,
            target_grad_x, target_grad_y, state, intr,
            min_depth=min_depth, max_depth=max_depth,
            sampling=sampling, gradient_at=gradient_at,
        )
        return normal_equations(r, J, valid, robust_loss, robust_delta)
    sg = source_grads if gradient_at == "esm" else None
    if gradient_at == "esm" and sg is None:
        raise ValueError("gradient_at='esm' needs source_grads=(gx0, gy0)")
    return fused_normal_equations_pallas(
        source_intensity, source_depth,
        pack_target(target_intensity, target_grad_x, target_grad_y), state,
        intr, min_depth, max_depth, sampling, robust_loss=robust_loss,
        robust_delta=robust_delta, source_grads=sg,
    )
