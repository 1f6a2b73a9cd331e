"""Pixel-sharded normal equations (torch port of
phovo_tpu/parallel/sharded_ne.py): the reference's dormant OpenMP row
parallelism (CPhotoconsistencyOdometryAnalytic.h:268-270) over the mesh's
'pixel' axis.

Each pixel rank takes its contiguous block of SOURCE rows and the whole
target (the warp gathers from anywhere in it; one image is cheaper to hold
than to exchange gathers every iteration), computes the NormalEquations of
its rows, and one all_reduce of the 6x6 system, the gradient, the cost and
the valid count merges them. The 6x6 solve then runs on every rank alike.
This is the latency decomposition (one frame, several cards); the
throughput one is parallel/batch.py's data axis.

phovo_tpu runs this as XLA, not Pallas, so it stays plain torch here: the
linearization is ops/residuals.photometric_residual_jacobian with the
block's row_offset, the solver solvers/gauss_newton.gauss_newton_level.
A one-rank mesh gives the unsharded linearization's bits.
"""

from __future__ import annotations

import torch

from phovo_tpu_torch.models.base import AlignmentResult
from phovo_tpu_torch.ops import pyramid as pyr
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.prep import device_unit_intensity
from phovo_tpu_torch.ops.residuals import NormalEquations, normal_equations, photometric_residual_jacobian
from phovo_tpu_torch.parallel.mesh import PIXEL_AXIS, Mesh, psum
from phovo_tpu_torch.solvers.gauss_newton import gauss_newton_level
from phovo_tpu_torch.utils.config import PhovoConfig


def sharded_normal_equations(
    mesh: Mesh,
    source_intensity: torch.Tensor,  # (H, W), the whole frame; this rank linearizes its block of rows
    source_depth: torch.Tensor,
    target_intensity: torch.Tensor,  # (H, W), whole on every rank
    target_grad_x: torch.Tensor,
    target_grad_y: torch.Tensor,
    state: torch.Tensor,
    intr: Intrinsics,
    min_depth: float,
    max_depth: float,
    sampling: str = "nearest",
) -> NormalEquations:
    """One linearization ('warped' gradients, no robust loss) with the
    source rows split over the mesh's pixel axis; the result is the same
    on every rank. A height the axis size does not divide raises
    ValueError."""
    n_shards = mesh.shape[PIXEL_AXIS]
    H = source_intensity.shape[0]
    if H % n_shards != 0:
        raise ValueError(
            f"image height {H} is not divisible by the mesh '{PIXEL_AXIS}' "
            f"axis size {n_shards}; pad the image or pick a pixel_parallel "
            f"that divides every pyramid level height"
        )
    rows = H // n_shards
    lo = mesh.index(PIXEL_AXIS) * rows
    r, J, valid = photometric_residual_jacobian(
        source_intensity[lo:lo + rows], source_depth[lo:lo + rows], target_intensity, target_grad_x,
        target_grad_y, state, intr, min_depth=min_depth, max_depth=max_depth, sampling=sampling,
        gradient_at="warped", row_offset=float(lo),
    )
    ne = normal_equations(r, J, valid)
    return NormalEquations(*psum(mesh, ne[:4], axes=(PIXEL_AXIS,)))


def make_pixel_sharded_aligner(mesh: Mesh, config: PhovoConfig):
    """A single-pair aligner whose every linearization is split over the
    mesh's pixel axis: align(si, sd, ti, td, intr, init_state) ->
    AlignmentResult (state (6,), diagnostics (L,)), the same on every rank.
    Each rank builds the whole pyramids; every level, its iteration budget
    0 or not, runs gauss_newton_level from coarse to fine, as phovo_tpu's
    form does (which takes the config's sampling, 'warped' gradients and
    no robust loss)."""

    def align(si, sd, ti, td, intr: Intrinsics, init_state) -> AlignmentResult:
        del td
        si = device_unit_intensity(si).to(torch.float32)
        ti = device_unit_intensity(ti).to(torch.float32)
        L, blur = config.num_levels, config.blur_filter_sizes
        int0 = pyr.build_pyramid(si, L, blur, blur_type=config.blur_type)
        dep0 = pyr.build_pyramid(sd.to(device=si.device, dtype=torch.float32), L)
        int1 = pyr.build_pyramid(ti, L, blur, blur_type=config.blur_type)
        gx1, gy1 = pyr.build_gradient_pyramid(int1, config.gradient_scales)
        state = torch.as_tensor(init_state, dtype=torch.float32).to(si.device)
        diags = [None] * L
        for level in range(L - 1, -1, -1):
            intr_l = intr.at_level(level)

            def linearize(s, lv=level, it=intr_l):
                return sharded_normal_equations(mesh, int0[lv], dep0[lv], int1[lv], gx1[lv], gy1[lv], s, it,
                                                config.min_depth, config.max_depth, config.sampling)

            res = gauss_newton_level(linearize, state, config.max_iterations[level],
                                     config.min_gradient_norms[level], config.lambda_steps[level])
            state = res.state
            diags[level] = res
        return AlignmentResult(
            state=state,
            iterations=torch.tensor([d.iterations for d in diags], dtype=torch.int32, device=state.device),
            gradient_norm=torch.stack([d.gradient_norm for d in diags]),
            cost=torch.stack([d.cost for d in diags]),
            num_valid=torch.stack([d.num_valid for d in diags]),
        )

    return align
