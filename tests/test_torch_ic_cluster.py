"""The cluster layout of the inverse-compositional kernels K-IC and K-ICpre,
on the CPU: the cluster-size rules, the residency rule's shared-memory
bytes, the C entry points' signatures against the ctypes table, and the
wrappers' argument tuples against those signatures.

The kernels themselves run only on the card (tests/test_torch_kernel_cuda.py);
here the wrappers' argument builders run on CPU tensors, whose pointers
nothing dereferences.
"""

import ctypes
import inspect

import pytest
import torch

from phovo_tpu_torch.ops import _build
from phovo_tpu_torch.ops import ic as IC
from phovo_tpu_torch.ops import ic_batch as ICB
from phovo_tpu_torch.ops.camera import TUM_FR1
from phovo_tpu_torch.ops.pyramid import level_shape

VGA = (480, 640)
LEVELS = [level_shape(VGA, level) for level in range(5)]
RULES = {"ic": ICB.ic_cluster_size, "icpre": IC.ic_precompute_cluster_size}
ENTRIES = {"ic": ("ic_gn_batch.cu", "phovo_ic_gn_level_batch"),
           "icpre": ("ic_precompute.cu", "phovo_ic_precompute")}
SIZES = (1, 2, 4, 8, 16)
# Dynamic shared memory one block may use on an H100 (227 KB)
H100_SMEM_PER_BLOCK = 232_448


def _signature(kind):
    source, name = ENTRIES[kind]
    return _build.entry_signatures((_build.CSRC / source).read_text())[name]


def _slot(kind, name):
    return [n for n, _ in _signature(kind)].index(name)


def _ic_args(B, H, W, **kw):
    """K-IC's argument tuple for B pairs of zero-stride packs (no memory
    behind them) and real (B, 4, 4) poses: (args, (state_in, state_out,
    diag))."""
    zero = torch.zeros(1)
    Ts = torch.eye(4).repeat(B, 1, 1)
    packs = (zero.expand(B, 4, H * W), zero.expand(B, 8, H * W), zero.expand(B, 36), zero.expand(B, H, W))
    return ICB._ic_launch_args(Ts, *packs, TUM_FR1, 7, 0.5, 0.25, H=H, W=W, **kw)


def _pre_args(B, H, W, **kw):
    """K-ICpre's argument tuple for B zero-stride frames: (args, (J8, L))."""
    frame = torch.zeros(1).expand(B, H, W)
    return IC._ic_precompute_launch_args(frame, frame, frame, frame, TUM_FR1, 0.3, 5.0, **kw)


@pytest.mark.parametrize("shape", LEVELS)
@pytest.mark.parametrize("kind", sorted(RULES))
def test_cluster_rule_is_a_power_of_two_up_to_16(kind, shape):
    c = RULES[kind](*shape)
    assert c in SIZES


@pytest.mark.parametrize("kind", sorted(RULES))
def test_cluster_rule_is_one_at_30x40(kind):
    """The coarsest level's iteration is mostly its serial tail, which every
    block of a cluster would repeat: one block a pair or frame."""
    assert RULES[kind](30, 40) == 1


@pytest.mark.parametrize("kind", sorted(RULES))
def test_cluster_rule_takes_only_the_shape(kind):
    assert list(inspect.signature(RULES[kind]).parameters) == ["H", "W"]


@pytest.mark.parametrize("kind", sorted(RULES))
def test_cluster_rule_grows_with_the_level(kind):
    sizes = [RULES[kind](*shape) for shape in reversed(LEVELS)]
    assert sizes == sorted(sizes) and sizes[-1] > 1


@pytest.mark.parametrize("cluster", SIZES)
@pytest.mark.parametrize("shape", LEVELS)
def test_resident_pack_bytes_fit_beside_the_static_shared_memory(shape, cluster):
    """A resident block keeps 11 rows of 4 bytes for each of its pixels,
    rounded up to whole sweeps of 256 threads; the rule makes a level
    resident only where that and the static shared memory fit in the
    232,448 bytes a block may use."""
    H, W = shape
    sweeps = -(-(H * W) // (cluster * 256))
    assert ICB.ic_pack_bytes(H, W, cluster) == 11 * 4 * sweeps * 256
    assert ICB.SMEM_PER_BLOCK == H100_SMEM_PER_BLOCK
    fits = ICB.ic_pack_bytes(H, W, cluster) + ICB.IC_STATIC_SMEM <= H100_SMEM_PER_BLOCK
    assert ICB.ic_pack_fits(H, W, cluster) == fits
    if ICB.ic_resident(H, W, cluster):
        assert fits


def test_resident_rule_at_the_vga_levels():
    """The rule's layout per level: the coarse levels keep the pack in
    shared memory, 480x640 (13.5 MB a pair) cannot."""
    layout = {shape: ICB.ic_resident(*shape, ICB.ic_cluster_size(*shape)) for shape in LEVELS}
    assert layout[(480, 640)] is False
    assert layout[(60, 80)] and layout[(30, 40)] and layout[(120, 160)]


@pytest.mark.parametrize("kind", sorted(ENTRIES))
def test_c_signatures_match_the_ctypes_table(kind):
    """The IC entries' parameters, parsed from their `extern "C"`
    signatures, against _build._ENTRIES' argtypes, argument by argument."""
    _, name = ENTRIES[kind]
    argtypes, restype = _build._ENTRIES[name]
    assert [t for _, t in _signature(kind)] == argtypes
    assert restype is ctypes.c_int
    assert "cluster" in [n for n, _ in _signature(kind)]


def _python_type_fits(value, ctype):
    if ctype is ctypes.c_void_p:
        return value is None or (isinstance(value, int) and not isinstance(value, bool))
    if ctype is ctypes.c_int:
        return isinstance(value, int) and not isinstance(value, bool)
    return isinstance(value, float)


@pytest.mark.parametrize("resident", [None, False, True])
@pytest.mark.parametrize("cluster", [None, *SIZES])
def test_ic_launch_args_follow_the_c_signature(cluster, resident):
    """K-IC's ctypes argument tuple has one value per parameter of the C
    entry, of its type, each in its slot: C and the residency are the
    rule's unless forced."""
    H, W = 120, 160
    args, (state_in, state_out, diag) = _ic_args(16, H, W, sampling="bilinear", stream=12345, cluster=cluster,
                                                  resident=resident)
    params = _signature("ic")
    assert len(args) == len(params)
    for (name, ctype), value in zip(params, args):
        assert _python_type_fits(value, ctype), (name, value)
    named = dict(zip([name for name, _ in params], args))
    c = ICB.ic_cluster_size(H, W) if cluster is None else cluster
    assert named["cluster"] == c
    assert named["resident"] == int(ICB.ic_resident(H, W, c) if resident is None else resident)
    assert (named["B"], named["H"], named["W"], named["bilinear"]) == (16, H, W, 1)
    assert (named["max_iterations"], named["min_gradient_norm"], named["lambda_step"]) == (7, 0.5, 0.25)
    assert (named["fx"], named["cy"], named["stream"]) == (TUM_FR1.fx, TUM_FR1.cy, 12345)
    assert named["state_in"] == state_in.data_ptr() and named["state_out"] == state_out.data_ptr()
    assert named["diag_out"] == diag.data_ptr()
    assert tuple(state_in.shape) == (16, 12) and tuple(diag.shape) == (16, 4)
    assert torch.equal(state_in[0], torch.tensor([1.0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0]))


@pytest.mark.parametrize("cluster", [None, *SIZES])
def test_ic_precompute_launch_args_follow_the_c_signature(cluster):
    H, W = 60, 80
    args, (J8, L) = _pre_args(5, H, W, stream=777, cluster=cluster)
    params = _signature("icpre")
    assert len(args) == len(params)
    for (name, ctype), value in zip(params, args):
        assert _python_type_fits(value, ctype), (name, value)
    named = dict(zip([name for name, _ in params], args))
    assert named["cluster"] == (IC.ic_precompute_cluster_size(H, W) if cluster is None else cluster)
    assert (named["B"], named["H"], named["W"], named["stream"]) == (5, H, W, 777)
    assert (named["min_depth"], named["max_depth"], named["fx"]) == (0.3, 5.0, TUM_FR1.fx)
    assert named["J8"] == J8.data_ptr() and named["L"] == L.data_ptr()
    assert tuple(J8.shape) == (5, 8, H * W) and tuple(L.shape) == (5, 36)


@pytest.mark.parametrize("shape", LEVELS)
def test_every_batch_gets_the_rules_layout(shape):
    """A level's cluster and residency are the same for a pair alone, a
    16-pair chunk and 256 pairs, and K-ICpre's for a frame alone and a
    batch: the order of the sums, hence the bits, cannot depend on B."""
    H, W = shape
    ic = {(args[_slot("ic", "cluster")], args[_slot("ic", "resident")])
          for args, _ in (_ic_args(B, H, W) for B in (1, 16, 256))}
    c = ICB.ic_cluster_size(H, W)
    assert ic == {(c, int(ICB.ic_resident(H, W, c)))}
    pre = {_pre_args(B, H, W)[0][_slot("icpre", "cluster")] for B in (1, 2, 16)}
    assert pre == {IC.ic_precompute_cluster_size(H, W)}
