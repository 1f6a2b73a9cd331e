"""K-LIN's split layout on the CPU (no card here): lin_split's rule, the
launch arguments it builds for the C entry (csrc/fused_lin.cu), and the
plain Gram it is held to against a per-pair sum of the same rows."""

import ctypes
import inspect

import pytest
import torch

from phovo_tpu_torch.ops import _build
from phovo_tpu_torch.ops import fused_batch as FB
from phovo_tpu_torch.ops.camera import TUM_FR1

VGA = [(480, 640), (240, 320), (120, 160), (60, 80), (30, 40)]


@pytest.mark.parametrize("shape,split", zip(VGA, [128, 32, 8, 2, 1]))
def test_lin_split_at_the_vga_levels(shape, split):
    assert FB.lin_split(*shape) == split


@pytest.mark.parametrize("shape", [*VGA, (96, 128), (1, 1), (7, 1000), (1080, 1920)])
def test_lin_split_is_a_power_of_two_of_about_2400_pixels_a_block(shape):
    G = FB.lin_split(*shape)
    N = shape[0] * shape[1]
    assert G & (G - 1) == 0
    assert G * 2_400 >= N and (G == 1 or (G // 2) * 2_400 < N)


def test_lin_split_takes_only_the_shape():
    assert list(inspect.signature(FB.lin_split).parameters) == ["H", "W"]


def _signature():
    src = (_build.CSRC / "fused_lin.cu").read_text()
    return _build.entry_signatures(src)["phovo_fused_lin"]


def _inputs(B, H, W, rows=4):
    return (torch.zeros(B, H * W), torch.zeros(B, rows, H * W), torch.zeros(B, 3, H, W), TUM_FR1,
            torch.zeros(B, 6))


@pytest.mark.parametrize("split", [None, 1, 8, 16])
@pytest.mark.parametrize("B", [1, 16])
def test_lin_launch_args_follow_the_c_signature(B, split):
    """One value per parameter of the C entry, of its type; G is the rule's
    unless forced; the split layout's scratch holds B * G * 35 floats (none
    for one block a pair)."""
    H, W = 120, 160
    args, (gram, partials, scale) = FB._lin_launch_args(*_inputs(B, H, W), H=H, W=W, sampling="bilinear",
                                                        robust_loss="huber", stream=4321, split=split)
    params = _signature()
    assert len(args) == len(params) == len(_build._ENTRIES["phovo_fused_lin"][0])
    for (name, ctype), value in zip(params, args):
        if ctype is ctypes.c_void_p:
            assert value is None or isinstance(value, int), name
        elif ctype is ctypes.c_int:
            assert isinstance(value, int) and not isinstance(value, bool), name
        else:
            assert isinstance(value, float), name
    named = dict(zip([n for n, _ in params], args))
    G = FB.lin_split(H, W) if split is None else split
    assert (named["split"], named["B"], named["H"], named["W"]) == (G, B, H, W)
    assert named["bilinear"] == 1 and named["stream"] == 4321
    want = B * G * 35 if G > 1 else 0
    assert partials.numel() == named["partials_len"] == want
    assert (named["partials"] is None) == (want == 0)
    assert named["gram_out"] == gram.data_ptr() and tuple(gram.shape) == (B, 8, 8)
    assert named["scale_in"] == scale.data_ptr()


def test_lin_launch_args_take_a_given_scratch():
    H, W = 120, 160
    scratch = torch.empty(7)
    args, (_, partials, _) = FB._lin_launch_args(*_inputs(2, H, W), H=H, W=W, partials=scratch)
    named = dict(zip([n for n, _ in _signature()], args))
    assert partials is scratch and named["partials_len"] == 7 and named["partials"] == scratch.data_ptr()


def test_every_batch_gets_the_rules_split():
    """A pair's split, hence the order of its sums, is the level's: the
    same for a pair alone and in a batch."""
    slot = [n for n, _ in _signature()].index("split")
    for H, W in VGA:
        seen = {FB._lin_launch_args(*_inputs(B, H, W), H=H, W=W)[0][slot] for B in (1, 16, 256)}
        assert seen == {FB.lin_split(H, W)}


@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
def test_plain_gram_is_the_sum_of_its_pixel_blocks(sampling):
    """The plain Gram equals the sum, over the split's strided pixel
    blocks, of the Grams of each block's pixels alone (what the kernel's
    blocks add), to float32 reassociation."""
    import numpy as np

    from phovo_tpu_torch.ops import pyramid as pyr
    from phovo_tpu_torch.ops.camera import Intrinsics
    from phovo_tpu_torch.ops.fused import pack_geometry, pack_target
    from phovo_tpu_torch.utils.synthetic import make_sequence

    intr = Intrinsics(128.0, 128.0, 63.5, 47.5)
    H, W = 96, 128
    I, D, _, _ = make_sequence(intr, (H, W), 3)
    It, Dt = torch.from_numpy(np.stack(I)), torch.from_numpy(np.stack(D))
    t_all = pack_target(It, pyr.scharr(It, "x", 0.0625), pyr.scharr(It, "y", 0.0625))
    i0, geom = It[:-1].reshape(2, -1).contiguous(), pack_geometry(Dt[:-1], intr, 0.3, 5.0).contiguous()
    states = torch.full((2, 6), 1e-3)
    kw = dict(H=H, W=W, sampling=sampling)
    whole = FB.fused_lin_batch(i0, geom, t_all[1:].contiguous(), intr, states, **kw)
    G, N = FB.lin_split(H, W), H * W
    assert G > 1
    parts = torch.zeros_like(whole)
    for rank in range(G):
        keep = torch.zeros(N, dtype=torch.bool)
        for start in range(rank * 256, N, G * 256):
            keep[start:start + 256] = True
        masked = geom.clone()
        masked[:, 3, ~keep] = 0.0  # the valid row: pixels outside the block count nothing
        part = FB.fused_lin_batch(i0, masked, t_all[1:].contiguous(), intr, states, **kw)
        parts += part
    parts[:, 6, 7] = parts[:, 7, 6] = 0.0
    scale = whole.abs().amax(dim=(1, 2), keepdim=True)
    assert bool(((parts - whole).abs() <= 1e-5 * scale).all())
    assert torch.equal(parts[:, 7, 7], whole[:, 7, 7])
