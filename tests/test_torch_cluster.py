"""The cluster layout of the level kernels K-GN and K-TR, on the CPU: the
cluster-size rule, the C entry points' signatures against the ctypes
table, and the wrappers' argument tuples against those signatures.

The kernels themselves run only on the card (tests/test_torch_kernel_cuda.py);
here the wrappers' argument builders run on CPU tensors, whose pointers
nothing dereferences.
"""

import ctypes
import inspect

import pytest
import torch

from phovo_tpu_torch.ops import _build
from phovo_tpu_torch.ops import fused_batch as FB
from phovo_tpu_torch.ops.camera import TUM_FR1
from phovo_tpu_torch.ops.pyramid import level_shape
from phovo_tpu_torch.solvers.trust_region import TROptions

VGA = (480, 640)
LEVELS = [level_shape(VGA, level) for level in range(5)]
ENTRIES = {"gn": ("fused_gn_batch.cu", "phovo_fused_gn_level_batch"),
           "tr": ("fused_tr_batch.cu", "phovo_fused_tr_level_batch")}


def _signature(kind):
    source, name = ENTRIES[kind]
    return _build.entry_signatures((_build.CSRC / source).read_text())[name]


def _packs(B, H, W, shared, channels=3):
    """Zero-stride CPU tensors of a level's shapes (no memory behind them):
    one source for every pair when shared."""
    S = 1 if shared else B
    zero = torch.zeros(1)
    return zero.expand(S, H * W), zero.expand(S, 4, H * W), zero.expand(B, channels, H, W), torch.zeros(B, 6)


def _build_args(kind, i0, geom, t_all, init, H, W, **kw):
    if kind == "gn":
        return FB._gn_launch_args(i0, geom, t_all, TUM_FR1, init, 7, 0.5, 0.25, H=H, W=W, **kw)
    return FB._tr_launch_args(i0, geom, t_all, TUM_FR1, init, TROptions(7), H=H, W=W, **kw)


def _launch_args(kind, B, H, W, shared=False, **kw):
    """The argument tuple for zero-stride packs, with the wrapper's shared
    flag given (its check wants real, contiguous packs)."""
    return _build_args(kind, *_packs(B, H, W, shared), H, W, shared=shared and B != 1, **kw)


@pytest.mark.parametrize("shape", [*LEVELS, (96, 128), (48, 64), (1, 1), (7, 1000), (1080, 1920)])
def test_cluster_size_is_a_power_of_two_up_to_16(shape):
    """The rule gives 1 or 8 blocks, 1 up to 4,800 pixels."""
    c = FB.cluster_size(*shape)
    assert c in (1, 8)
    assert c == (1 if shape[0] * shape[1] <= 4_800 else 8)


@pytest.mark.parametrize("shape", [(30, 40), (60, 80)])
def test_cluster_size_is_one_at_the_coarse_levels(shape):
    assert FB.cluster_size(*shape) == 1


def test_cluster_size_grows_with_the_level():
    sizes = [FB.cluster_size(*shape) for shape in reversed(LEVELS)]
    assert sizes == sorted(sizes) and sizes[-1] > 1


def test_cluster_size_takes_only_the_shape():
    assert list(inspect.signature(FB.cluster_size).parameters) == ["H", "W"]


@pytest.mark.parametrize("kind", ["gn", "tr"])
@pytest.mark.parametrize("shape", LEVELS)
def test_every_batch_and_mode_gets_the_rules_cluster(kind, shape):
    """A level's cluster is the same for a pair alone, a shared source, a
    16-pair chunk and 256 pairs (and, for K-GN, the bi-objective level):
    the order of the sums, hence the bits, cannot depend on them."""
    H, W = shape
    slot = [name for name, _ in _signature(kind)].index("cluster")
    seen = {_launch_args(kind, B, H, W, shared)[0][slot] for B, shared in ((1, False), (16, True), (16, False), (256, False))}
    if kind == "gn":
        i0, geom, _, init = _packs(8, H, W, False)
        t6 = torch.zeros(1).expand(8, 6, H, W)
        args, _ = FB._gn_launch_args(i0, geom, t6, TUM_FR1, init, 3, 0.0, 1.0, H=H, W=W, shared=False,
                                     depth_gains=torch.ones(8))
        seen.add(args[slot])
    assert seen == {FB.cluster_size(H, W)}


@pytest.mark.parametrize("name", sorted(_build._ENTRIES))
def test_c_signatures_match_the_ctypes_table(name):
    """Every entry point's parameters, parsed from the `extern "C"`
    signature in csrc/*.cu, against _build._ENTRIES' argtypes, argument by
    argument."""
    found = {}
    for source in sorted(_build.CSRC.glob("*.cu")):
        found.update(_build.entry_signatures(source.read_text()))
    assert set(found) == set(_build._ENTRIES)
    argtypes, restype = _build._ENTRIES[name]
    assert [t for _, t in found[name]] == argtypes
    assert restype is ctypes.c_int


def test_entry_signatures_parses_pointers_and_scalars():
    src = 'static int x;\nextern "C" int f(const float* a, float *b, int n,\n    float s, void* stream) {\n}'
    assert _build.entry_signatures(src) == {
        "f": [("a", ctypes.c_void_p), ("b", ctypes.c_void_p), ("n", ctypes.c_int), ("s", ctypes.c_float),
              ("stream", ctypes.c_void_p)],
    }


def _python_type_fits(value, ctype):
    if ctype is ctypes.c_void_p:
        return value is None or (isinstance(value, int) and not isinstance(value, bool))
    if ctype is ctypes.c_int:
        return isinstance(value, int) and not isinstance(value, bool)
    return isinstance(value, float)


@pytest.mark.parametrize("kind", ["gn", "tr"])
@pytest.mark.parametrize("cluster", [None, 1, 2, 16])
def test_launch_args_follow_the_c_signature(kind, cluster):
    """The wrappers' ctypes argument tuple has one value per parameter of
    the C entry, of its type, each in its slot: C is cluster_size(H, W)
    unless forced, B, H, W and the flags where the signature names them."""
    H, W = 120, 160
    args, outs = _launch_args(kind, 16, H, W, shared=True, sampling="bilinear", robust_loss="huber", stream=12345,
                              cluster=cluster)
    params = _signature(kind)
    assert len(args) == len(params)
    for (name, ctype), value in zip(params, args):
        assert _python_type_fits(value, ctype), (name, value)
    named = dict(zip([name for name, _ in params], args))
    assert named["cluster"] == (FB.cluster_size(H, W) if cluster is None else cluster)
    assert (named["B"], named["H"], named["W"]) == (16, H, W)
    assert (named["bilinear"], named["loss"], named["shared_source"]) == (1, 1, 1)
    assert named["max_iterations"] == 7 and named["stream"] == 12345
    assert (named["fx"], named["cy"]) == (TUM_FR1.fx, TUM_FR1.cy)
    assert named["states_out"] == outs[0].data_ptr() and named["diag_out"] == outs[1].data_ptr()
    if kind == "gn":
        assert (named["esm"], named["min_gradient_norm"], named["lambda_step"]) == (0, 0.5, 0.25)
        assert named["depth_gains"] is None and named["scale_in"] == outs[2].data_ptr()
    else:
        assert (named["delta"], named["initial_radius"]) == (0.1, TROptions(7).initial_trust_region_radius)


@pytest.mark.parametrize("kind", ["gn", "tr"])
def test_launch_args_point_every_pair_at_its_own_source_unless_shared(kind):
    """The shared_source flag is the inputs check's answer (_check_inputs),
    given by the wrapper or, left out, asked by the builder itself."""
    slot = [name for name, _ in _signature(kind)].index("shared_source")
    H, W = 6, 8
    # (pairs, source packs, flag): B = 1 is never counted as shared
    for B, S, flag in ((1, 1, 0), (4, 1, 1), (4, 4, 0)):
        packs = (torch.zeros(S, H * W), torch.zeros(S, 4, H * W), torch.zeros(B, 3, H, W), torch.zeros(B, 6))
        shared = FB._check_inputs(*packs, H, W, "bilinear")
        assert shared == bool(flag)
        assert _build_args(kind, *packs, H, W, shared=shared)[0][slot] == flag
        assert _build_args(kind, *packs, H, W, sampling="bilinear")[0][slot] == flag
