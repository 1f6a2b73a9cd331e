"""The prep layer (ops/prep.py) on the CPU: the torch chain, moved beside
K-PREP, gives the packs the code before it gave, bit for bit (the five
ceres levels, the analytic preset's levels 2-4, the ESM rows, targets
only, a chunk after a float32 or uint8 carry with uint8 and uint16
frames, one object-API pair, a blurred preset); the entries route CPU
tensors, blurred presets and inexact shapes to the torch chain and count
it; K-PREP's wrapper refuses what the kernel does not take. K-PREP itself
runs only on the card (tests/test_torch_kernel_cuda.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from phovo_tpu_torch.models import analytic, autodiff
from phovo_tpu_torch.ops import prep
from phovo_tpu_torch.ops import pyramid as pyr
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.fused import fused_tr_level, pack_geometry, pack_target
from phovo_tpu_torch.utils.config import builtin_config_dir, load_builtin

SHAPE = (96, 128)  # 96x128 halves exactly four times
INTR = Intrinsics(128.0, 128.0, 63.5, 47.5)
DEPTH_SCALE = 1.0 / 5000.0
CERES = load_builtin("config_5_level_optimization_ceres")
ANALYTIC = load_builtin("config_5_level_optimization_analytic")
CONFIGS = {
    "ceres": CERES,
    "analytic": ANALYTIC,
    "esm": dataclasses.replace(ANALYTIC, gradient_at="esm"),
    "blurred": load_builtin("config_3_level_optimization_ceres"),
}


def _storage(n, seed=0):
    """n frames in storage dtype: uint8 intensity, uint16 depth counts with
    holes and depths beyond 5 m."""
    rng = np.random.default_rng(seed)
    i8 = rng.integers(0, 256, (n, *SHAPE), dtype=np.uint8)
    d16 = rng.integers(1, 30_000, (n, *SHAPE), dtype=np.uint16)
    d16[rng.random((n, *SHAPE)) < 0.1] = 0
    return torch.from_numpy(i8), torch.from_numpy(d16)


def _float_frames(n, seed=0):
    i8, d16 = _storage(n, seed)
    return i8.to(torch.float32) * (1.0 / 255.0), d16.to(torch.float32) * float(np.float32(DEPTH_SCALE))


# -- the code before the prep layer, as it was ---------------------------------


def _before_prep_frame_analytic(intensity, depth, intr, config):
    L = config.num_levels
    esm = config.gradient_at == "esm"
    out = {}
    int_p = pyr.build_pyramid(intensity, L, config.blur_filter_sizes, blur_type=config.blur_type)
    dep_p = pyr.build_pyramid(depth, L)
    for level in range(L):
        if config.max_iterations[level] <= 0:
            continue
        img = int_p[level]
        scale = config.gradient_scales[level]
        gx, gy = pyr.scharr(img, "x", scale), pyr.scharr(img, "y", scale)
        out[level] = (
            img.reshape(*img.shape[:-2], -1),
            pack_geometry(dep_p[level], intr.at_level(level), config.min_depth, config.max_depth,
                          (gx, gy) if esm else None),
            pack_target(img, gx, gy),
        )
    return out


def _before_prep_frame_targets(intensity, config):
    out = {}
    int_p = pyr.build_pyramid(intensity, config.num_levels, config.blur_filter_sizes, blur_type=config.blur_type)
    for level, img in enumerate(int_p):
        if config.max_iterations[level] <= 0:
            continue
        scale = config.gradient_scales[level]
        out[level] = pack_target(img, pyr.scharr(img, "x", scale), pyr.scharr(img, "y", scale))
    return out


def _before_chunk_device_prep(carry_intensity, carry_depth, intensities, depths, depth_scale):
    if depth_scale is not None and depths.dtype != torch.float32:
        depths = depths.to(torch.float32) * float(np.float32(depth_scale))
    intensities = prep.device_unit_intensity(intensities).to(torch.float32)
    carry_f = prep.device_unit_intensity(carry_intensity).to(torch.float32)
    return torch.cat([carry_f[None], intensities]), torch.cat([carry_depth.to(torch.float32)[None], depths])


def _before_pair_packs(si, sd, ti, intr, config):
    """align_autodiff's packs before the prep layer: the pyramids of the
    pair, each level's target pack, and fused_tr_level's source pack."""
    L, blur = config.num_levels, config.blur_filter_sizes
    si = prep.device_unit_intensity(si).to(torch.float32)
    ti = prep.device_unit_intensity(ti).to(torch.float32)
    int0 = pyr.build_pyramid(si, L, blur, blur_type=config.blur_type)
    dep0 = pyr.build_pyramid(sd.to(torch.float32), L)
    int1 = pyr.build_pyramid(ti, L, blur, blur_type=config.blur_type)
    out = {}
    for level in range(L):
        if config.max_iterations[level] <= 0:
            continue
        img, scale = int1[level], config.gradient_scales[level]
        H, W = img.shape
        out[level] = (
            int0[level].reshape(1, H * W),
            pack_geometry(dep0[level], intr.at_level(level), config.min_depth, config.max_depth)[None],
            pack_target(img, pyr.scharr(img, "x", scale), pyr.scharr(img, "y", scale))[None],
        )
    return out


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for level in got:
        g_parts = got[level] if isinstance(got[level], tuple) else (got[level],)
        w_parts = want[level] if isinstance(want[level], tuple) else (want[level],)
        assert len(g_parts) == len(w_parts)
        for g, w in zip(g_parts, w_parts):
            assert g.dtype == w.dtype and g.shape == w.shape, level
            assert torch.equal(g, w), level


# -- the torch chain gives the bits of the code before it -----------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prep_frames_gives_the_packs_of_before(name):
    I, D = _float_frames(3)
    cfg = CONFIGS[name]
    _assert_same(analytic.prep_frame_analytic(I, D, INTR, cfg), _before_prep_frame_analytic(I, D, INTR, cfg))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prep_targets_gives_the_packs_of_before(name):
    I, _ = _float_frames(3)
    cfg = CONFIGS[name]
    _assert_same(analytic.prep_frame_targets(I, cfg), _before_prep_frame_targets(I, cfg))


def test_prep_frames_takes_a_single_frame_and_uint8():
    """No leading dims, and uint8 intensity converted as device_unit_intensity
    converts it."""
    i8, _ = _storage(1)
    I, D = _float_frames(1)
    _assert_same(prep.prep_frames(I[0], D[0], INTR, CERES), _before_prep_frame_analytic(I[0], D[0], INTR, CERES))
    _assert_same(prep.prep_frames(i8, D, INTR, CERES), _before_prep_frame_analytic(I, D, INTR, CERES))


@pytest.mark.parametrize("name", ["ceres", "analytic", "esm"])
@pytest.mark.parametrize("carry", ["float32", "uint8"])
@pytest.mark.parametrize("depth", ["counts", "metres"])
def test_prep_chunk_gives_the_pairs_of_before(name, carry, depth):
    """A chunk after the carry frame (float32, or uint8 at a sequence's
    start), new frames uint8 with uint16 counts or float32 metres: the
    pairs' packs and the carry of chunk_device_prep and the prep before."""
    i8, d16 = _storage(5)
    ci = i8[0] if carry == "uint8" else prep.device_unit_intensity(i8[0])
    cd = d16[0].to(torch.float32) * float(np.float32(DEPTH_SCALE))
    frames = d16[1:] if depth == "counts" else d16[1:].to(torch.float32) * float(np.float32(DEPTH_SCALE))
    cfg = CONFIGS[name]
    packs, gci, gcd = prep.prep_chunk(ci, cd, i8[1:], frames, DEPTH_SCALE, INTR, cfg)
    I, D = _before_chunk_device_prep(ci, cd, i8[1:], frames, DEPTH_SCALE)
    full = _before_prep_frame_analytic(I, D, INTR, cfg)
    _assert_same(packs, {level: (i0[:-1], geom[:-1], t[1:]) for level, (i0, geom, t) in full.items()})
    assert torch.equal(gci, I[-1]) and torch.equal(gcd, D[-1])


@pytest.mark.parametrize("name", ["ceres", "blurred"])
def test_prep_pair_gives_align_autodiffs_packs_of_before(name):
    i8, d16 = _storage(2)
    sd = d16[0].to(torch.float32) * float(np.float32(DEPTH_SCALE))
    cfg = CONFIGS[name]
    _assert_same(prep.prep_pair(i8[0], sd, i8[1], INTR, cfg), _before_pair_packs(i8[0], sd, i8[1], INTR, cfg))


def test_align_autodiff_gives_the_result_of_before():
    """One pair through align_autodiff: the result of the per-level
    fused_tr_level calls on the pyramids, as it ran before."""
    i8, d16 = _storage(2)
    sd = d16[0].to(torch.float32) * float(np.float32(DEPTH_SCALE))
    packs = _before_pair_packs(i8[0], sd, i8[1], INTR, CERES)
    si = prep.device_unit_intensity(i8[0])
    dep0 = pyr.build_pyramid(sd, CERES.num_levels)
    state = torch.zeros(6)
    diags = {}
    for level in sorted(packs, reverse=True):
        H, W = pyr.level_shape(SHAPE, level)
        i0 = pyr.build_pyramid(si, CERES.num_levels)[level]
        state, its, cost, gnorm, _, nvalid, _ = fused_tr_level(
            i0, dep0[level], packs[level][2][0], INTR.at_level(level), state, CERES.min_depth, CERES.max_depth,
            CERES.trust_region_options(level),
        )
        diags[level] = (int(its), float(cost), float(gnorm), float(nvalid))
    res = autodiff.align_autodiff(i8[0], sd, i8[1], d16[1], INTR, torch.zeros(6), CERES)
    assert torch.equal(res.state, state)
    for level, (its, cost, gnorm, nvalid) in diags.items():
        assert int(res.iterations[level]) == its
        assert (float(res.cost[level]), float(res.gradient_norm[level]), float(res.num_valid[level])) == (
            cost, gnorm, nvalid)


def test_chunk_entries_give_the_results_of_before():
    """Both chunked entries from zero, on the prep layer's route: the
    results and carries of the sequence entries on chunk_device_prep's
    frames, as they ran before."""
    i8, d16 = _storage(4)
    ci, cd = prep.device_unit_intensity(i8[0]), d16[0].to(torch.float32) * float(np.float32(DEPTH_SCALE))
    I, D = _before_chunk_device_prep(ci, cd, i8[1:], d16[1:], DEPTH_SCALE)
    cases = ((analytic.align_sequence_chunk, analytic.align_sequence, ANALYTIC),
             (autodiff.align_sequence_chunk_autodiff, autodiff.align_sequence_autodiff, CERES))
    for chunk, sequence, cfg in cases:
        res, gci, gcd = chunk(ci, cd, i8[1:], d16[1:], INTR, cfg, depth_scale=DEPTH_SCALE)
        want = sequence(I, D, INTR, cfg)
        assert all(torch.equal(a, b) for a, b in zip(res, want))
        assert torch.equal(gci, I[-1]) and torch.equal(gcd, D[-1])


# -- routing and counting ---------------------------------------------------------


def _counts():
    return prep.PREP_LAUNCHES, prep.PREP_TORCH_CALLS


@pytest.mark.parametrize("entry", ["frames", "targets", "chunk", "pair"])
def test_cpu_calls_take_the_torch_chain_and_count_it(entry):
    i8, d16 = _storage(3)
    I, D = _float_frames(3)
    calls = {
        "frames": lambda: prep.prep_frames(I, D, INTR, CERES),
        "targets": lambda: prep.prep_targets(i8, CERES),
        "chunk": lambda: prep.prep_chunk(I[0], D[0], i8[1:], d16[1:], DEPTH_SCALE, INTR, CERES),
        "pair": lambda: prep.prep_pair(i8[0], D[0], i8[1], INTR, CERES),
    }
    launches, torch_calls = _counts()
    calls[entry]()
    assert _counts() == (launches, torch_calls + 1)


def test_kernel_takes_nine_of_the_twelve_shipped_presets_at_vga():
    """The three that blur an active level go to the torch chain."""
    taken = {p.stem: prep.kernel_takes(load_builtin(p.stem), (480, 640))
             for p in builtin_config_dir().glob("*.yml")}
    assert len(taken) == 12
    assert sorted(name for name, ok in taken.items() if not ok) == [
        "config_3_level_optimization_ceres", "config_only_level_1_ceres", "config_only_level_2_ceres"]


@pytest.mark.parametrize("shape,ok", [
    ((480, 640), True), (SHAPE, True), ((100, 130), False), ((24, 32), False), ((16, 16), False),
    ((480, 642), False),
])
def test_kernel_takes_only_exact_power_of_two_levels_of_two_pixels_or_more(shape, ok):
    """(100, 130): level 1 is 50x65, level 2 25x32 (not exact); (24, 32):
    level 4 rounds to 2x2 (not exact); (16, 16): level 4 is 1x1."""
    assert prep.kernel_takes(CERES, shape) is ok


def test_kernel_takes_reads_only_the_active_levels():
    """An inexact or blurred level that is skipped does not matter."""
    cfg = dataclasses.replace(CERES, blur_filter_sizes=(5, 0, 0, 0, 0), max_iterations=(0, 2, 5, 10, 50))
    assert prep.kernel_takes(cfg, (480, 640))
    assert not prep.kernel_takes(dataclasses.replace(cfg, max_iterations=(1, 2, 5, 10, 50)), (480, 640))
    assert prep.kernel_takes(dataclasses.replace(CERES, max_iterations=(2, 2, 0, 0, 0)), (100, 130))


# -- K-PREP's wrapper refuses what the kernel does not take ------------------------


def _wrapper_args(**change):
    i8, d16 = _storage(3)
    args = dict(head=(prep.device_unit_intensity(i8[0]), d16[0].to(torch.float32)), body_i=i8[1:],
                body_d=d16[1:], intr=INTR, config=CERES, sources=(0, 2), targets=(1, 3), depth_scale=DEPTH_SCALE)
    return {**args, **change}


@pytest.mark.parametrize("fault,match", [
    ("intensity dtype", "body intensity must be one of"),
    ("depth dtype", "body depth must be one of"),
    ("head depth dtype", "head depth must be one of"),
    ("contiguity", "must be contiguous"),
    ("shape", "body depth has shape"),
    ("no depth scale", "need a depth_scale"),
    ("ranges", "must be ranges"),
    ("sources without depth", "need their depth"),
    ("device", "no K-PREP for device cpu"),
])
def test_k_prep_wrapper_raises_on_what_the_kernel_does_not_take(fault, match):
    i8, d16 = _storage(3)
    changes = {
        "intensity dtype": dict(body_i=i8[1:].to(torch.int16)),
        "depth dtype": dict(body_d=d16[1:].to(torch.float64)),
        "head depth dtype": dict(head=(i8[0], d16[0])),
        "contiguity": dict(body_i=i8[1:].transpose(1, 2).contiguous().transpose(1, 2)),
        "shape": dict(body_d=d16[1:, :, :-1].contiguous()),
        "no depth scale": dict(depth_scale=None),
        "ranges": dict(sources=(0, 1), targets=(2, 3)),
        "sources without depth": dict(body_d=None),
        "device": {},
    }[fault]
    launches = prep.PREP_LAUNCHES
    with pytest.raises(ValueError, match=match):
        prep.prep_levels(**_wrapper_args(**changes))
    assert prep.PREP_LAUNCHES == launches
