"""A pair is a batch of one: the analytic, bi-objective and IC backends run
a single pair and a warm chain through their sequences' one level loop
(align_pairs_levelmajor, _ic_pairs_levelmajor) and the prep layer. On the
CPU each entry gives the result the code before it gave, bit for bit:
align_analytic (the analytic preset from uint8 frames, ESM, a blurred
preset, Student-t), the analytic warm chain, align_biobjective and its warm
chain, align_ic; that code, per-pair level loops over the per-level
wrappers, is copied below as it was. align_analytic takes the prep layer
(one torch-chain call a pair on the CPU) and reaches the level kernel
through analytic.fused_gn_level_batch. The card's side is
tests/test_torch_kernel_cuda.py."""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from phovo_tpu_torch.models import analytic, biobjective, ic
from phovo_tpu_torch.models.base import prepped_chain
from phovo_tpu_torch.ops import ic as ic_ops
from phovo_tpu_torch.ops import prep
from phovo_tpu_torch.ops import pyramid as pyr
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.fused import fused_gn_level, fused_gn_level_packs, pack_geometry, pack_target
from phovo_tpu_torch.utils.config import load_builtin
from phovo_tpu_torch.utils.synthetic import make_sequence

SHAPE = (96, 128)
INTR = Intrinsics(128.0, 128.0, 63.5, 47.5)


def _iterating(config, **changes):
    """config with a gradient-norm floor that a 96x128 pair does not reach
    at once (the presets' 300 is sized for 640x480), so every level runs
    several iterations."""
    return dataclasses.replace(config, min_gradient_norms=(1e-3,) * config.num_levels, **changes)


ANALYTIC = _iterating(load_builtin("config_5_level_optimization_analytic"))
BLURRED = _iterating(load_builtin("config_3_level_optimization_ceres"))
CONFIGS = {
    "analytic": ANALYTIC,
    "esm": dataclasses.replace(ANALYTIC, gradient_at="esm", sampling="bilinear"),
    "blurred": BLURRED,
    "tdist": dataclasses.replace(ANALYTIC, robust_loss="tdist", robust_delta=0.05),
    "huber": dataclasses.replace(ANALYTIC, robust_loss="huber", robust_delta=0.05),
    "ic_nearest": dataclasses.replace(ANALYTIC, gradient_scales=(0.03125,) * 5),
    "ic_blurred": dataclasses.replace(BLURRED, gradient_scales=(0.03125,) * 3),
}


def _frames(n=3):
    """n frames of a synthetic sequence: intensity uint8, depth float32
    metres."""
    I, D, _, _ = make_sequence(INTR, SHAPE, n, seed=3)
    i8 = torch.from_numpy(np.stack([np.round(np.asarray(x) * 255.0) for x in I]).astype(np.uint8))
    return i8, torch.from_numpy(np.stack(D).astype(np.float32))


# -- the code before, as it was ----------------------------------------------------


def _before_align_analytic(si, sd, ti, intr, init_state, config):
    """align_analytic's kernel route: the pair's pyramids, then one
    fused_gn_level call a level."""
    si = prep.device_unit_intensity(si).to(torch.float32)
    ti = prep.device_unit_intensity(ti).to(torch.float32)
    L, blur, scales = config.num_levels, config.blur_filter_sizes, config.gradient_scales
    int0 = pyr.build_pyramid(si, L, blur, blur_type=config.blur_type)
    dep0 = pyr.build_pyramid(sd.to(torch.float32), L)
    int1 = pyr.build_pyramid(ti, L, blur, blur_type=config.blur_type)
    gx1, gy1 = pyr.build_gradient_pyramid(int1, scales)
    esm = config.gradient_at == "esm"
    if esm:
        gx0, gy0 = pyr.build_gradient_pyramid(int0, scales)

    def run_level(level, state, sigma, burnin):
        return fused_gn_level(
            int0[level], dep0[level], pack_target(int1[level], gx1[level], gy1[level]),
            intr.at_level(level), state, config.min_depth, config.max_depth,
            *analytic._gn_options(config, level), config.sampling,
            robust_loss=config.robust_loss, robust_delta=config.robust_delta,
            source_grads=(gx0[level], gy0[level]) if esm else None, robust_scale=sigma, tdist_burnin=burnin,
        )[:5]

    return analytic._coarse_to_fine(run_level, init_state.to(torch.float32), config)


def _before_align_prepped(src, tgt, shape, intr, init_state, config, bi=False):
    """align_prepped (and with bi align_prepped_biobjective): one
    fused_gn_level_packs call a level on the frames' packs."""

    def run_level(level, state, sigma, burnin):
        H, W = pyr.level_shape(shape, level)
        gain = tgt[level][3] if bi else None
        kwargs = dict(bi=True, depth_gain=gain) if bi else dict(
            esm=config.gradient_at == "esm", robust_scale=sigma, tdist_burnin=burnin)
        return fused_gn_level_packs(
            src[level][0], src[level][1], tgt[level][2], intr.at_level(level), state,
            *analytic._gn_options(config, level), H=H, W=W, sampling=config.sampling,
            robust_loss=config.robust_loss, robust_delta=config.robust_delta, **kwargs,
        )[:5]

    return analytic._coarse_to_fine(run_level, init_state.to(torch.float32), config)


def _before_align_biobjective(si, sd, ti, td, intr, init_state, config):
    """align_biobjective's kernel route: the pair's pyramids, depth columns
    and gains, then one fused_gn_level call a level."""
    si = prep.device_unit_intensity(si).to(torch.float32)
    ti = prep.device_unit_intensity(ti).to(torch.float32)
    L, blur, scales = config.num_levels, config.blur_filter_sizes, config.gradient_scales
    int0 = pyr.build_pyramid(si, L, blur, blur_type=config.blur_type)
    dep0 = pyr.build_pyramid(sd.to(torch.float32), L)
    int1 = pyr.build_pyramid(ti, L, blur, blur_type=config.blur_type)
    dep1 = pyr.build_pyramid(td.to(torch.float32), L)
    gx1, gy1 = pyr.build_gradient_pyramid(int1, scales)

    def run_level(level, state, sigma, burnin):
        dep, dgx, dgy = biobjective._depth_cols(dep1[level], config, level)
        return fused_gn_level(
            int0[level], dep0[level], pack_target(int1[level], gx1[level], gy1[level]),
            intr.at_level(level), state, config.min_depth, config.max_depth,
            *analytic._gn_options(config, level), config.sampling,
            depth_cols=(dep, dgx, dgy), depth_gain=biobjective._gain(int1[level], dep),
            robust_loss=config.robust_loss, robust_delta=config.robust_delta,
        )[:5]

    return analytic._coarse_to_fine(run_level, init_state.to(torch.float32), config)


def _before_align_ic(si, sd, ti, intr, init_state, config):
    """align_ic's kernel route: the pair's pyramids and source gradients,
    then per level ic_precompute_batch at B = 1 and ic_gn_level."""
    from phovo_tpu_torch.ops import se3

    si = prep.device_unit_intensity(si).to(torch.float32)
    ti = prep.device_unit_intensity(ti).to(torch.float32)
    L, blur = config.num_levels, config.blur_filter_sizes
    int0 = pyr.build_pyramid(si, L, blur, blur_type=config.blur_type)
    dep0 = pyr.build_pyramid(sd.to(torch.float32), L)
    int1 = pyr.build_pyramid(ti, L, blur, blur_type=config.blur_type)
    gx0, gy0 = pyr.build_gradient_pyramid(int0, config.gradient_scales)
    limits = (config.min_depth, config.max_depth)

    def run_level(level, T):
        intr_l = intr.at_level(level)
        frame = (x[level][None].contiguous() for x in (int0, dep0, gx0, gy0))
        J8, Lrow = ic_ops.ic_precompute_batch(*frame, intr_l, *limits)
        return ic_ops.ic_gn_level(
            T, pack_geometry(dep0[level], intr_l, *limits), J8[0], Lrow[0], int1[level],
            intr_l, *ic._gn_options(config, level), config.sampling, config.mix_mode,
        )[:5]

    return ic._coarse_to_fine(run_level, se3.pose_matrix(init_state.to(torch.float32)), config)


def _bi_warm_chain_before(I, D, config):
    prep_, shape, B = biobjective._prep_chain(I, D, INTR, config)
    return prepped_chain(
        prep_, B, lambda src, tgt, init: _before_align_prepped(src, tgt, shape, INTR, init, config, bi=True),
        I.device,
    )


def _analytic_warm_chain_before(I, D, config):
    prep_ = analytic.prep_frame_analytic(I, D, INTR, config)
    return prepped_chain(
        prep_, I.shape[0] - 1,
        lambda src, tgt, init: _before_align_prepped(src, tgt, SHAPE, INTR, init, config), I.device,
    )


# -- every changed entry gives the bits of before ------------------------------------

INIT = torch.tensor([0.004, -0.003, 0.002, 0.001, -0.002, 0.0015])


def _pair():
    i8, D = _frames(2)
    return i8[0], D[0], i8[1], D[1]


CASES = {
    "align_analytic-analytic": lambda: _case_analytic("analytic"),
    "align_analytic-esm": lambda: _case_analytic("esm"),
    "align_analytic-blurred": lambda: _case_analytic("blurred"),
    "align_analytic-tdist": lambda: _case_analytic("tdist"),
    "analytic_warm_chain-analytic": lambda: _case_analytic_chain("analytic"),
    "analytic_warm_chain-esm": lambda: _case_analytic_chain("esm"),
    "align_biobjective-none": lambda: _case_bi("analytic"),
    "align_biobjective-huber": lambda: _case_bi("huber"),
    "bi_warm_chain-none": lambda: _case_bi_chain("analytic"),
    "bi_warm_chain-huber": lambda: _case_bi_chain("huber"),
    "align_ic-nearest": lambda: _case_ic("ic_nearest"),
    "align_ic-blurred": lambda: _case_ic("ic_blurred"),
}


def _case_analytic(name):
    si, sd, ti, td = _pair()
    cfg = CONFIGS[name]
    return (analytic.align_analytic(si, sd, ti, td, INTR, INIT, cfg),
            _before_align_analytic(si, sd, ti, INTR, INIT, cfg))


def _case_analytic_chain(name):
    i8, D = _frames(3)
    I = prep.device_unit_intensity(i8)
    cfg = CONFIGS[name]
    return analytic.align_sequence(I, D, INTR, cfg, warm_start=True), _analytic_warm_chain_before(I, D, cfg)


def _case_bi(name):
    si, sd, ti, td = _pair()
    cfg = CONFIGS[name]
    return (biobjective.align_biobjective(si, sd, ti, td, INTR, INIT, cfg),
            _before_align_biobjective(si, sd, ti, td, INTR, INIT, cfg))


def _case_bi_chain(name):
    i8, D = _frames(3)
    I = prep.device_unit_intensity(i8)
    cfg = CONFIGS[name]
    return biobjective.align_sequence_biobjective(I, D, INTR, cfg, warm_start=True), _bi_warm_chain_before(I, D, cfg)


def _case_ic(name):
    si, sd, ti, td = _pair()
    cfg = CONFIGS[name]
    return ic.align_ic(si, sd, ti, td, INTR, INIT, cfg), _before_align_ic(si, sd, ti, INTR, INIT, cfg)


@pytest.mark.parametrize("case", sorted(CASES))
def test_entry_gives_the_result_of_before(case):
    got, want = CASES[case]()
    for field, g, w in zip(got._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, field
        assert torch.equal(g, w), field


def test_align_analytic_takes_the_prep_layer_once_a_pair():
    """On the CPU the pair's packs are one torch-chain call of the prep
    layer (on the card, one K-PREP launch where it takes the frames)."""
    si, sd, ti, td = _pair()
    launches, torch_calls = prep.PREP_LAUNCHES, prep.PREP_TORCH_CALLS
    analytic.align_analytic(si, sd, ti, td, INTR, INIT, ANALYTIC)
    assert (prep.PREP_LAUNCHES, prep.PREP_TORCH_CALLS) == (launches, torch_calls + 1)


def test_align_analytic_reaches_the_level_kernel_through_the_models_seam():
    """align_analytic calls analytic.fused_gn_level_batch once per active
    level at B = 1, so patching that name swaps the kernel of a single
    pair too."""
    si, sd, ti, td = _pair()
    with mock.patch.object(analytic, "fused_gn_level_batch", wraps=analytic.fused_gn_level_batch) as level:
        analytic.align_analytic(si, sd, ti, td, INTR, INIT, ANALYTIC)
    active = sum(its > 0 for its in ANALYTIC.max_iterations)
    assert level.call_count == active
    assert all(call.args[0].shape[0] == 1 for call in level.call_args_list)
