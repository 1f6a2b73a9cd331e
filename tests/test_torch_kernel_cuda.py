"""The CUDA level kernel against its plain torch version, on the card.

Needs an NVIDIA GPU and nvcc; skipped elsewhere. Run on the card with
    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py
(tests/conftest.py imports jax, which the port's machines
need not have). The kernel is held to the plain version, which the CPU
tests hold to phovo_tpu. Tolerance: states 2e-4 absolute and cost 1e-4
relative (pixel sums in another order), iterations and valid counts equal
(the per-pixel arithmetic is the same, built without contracted
multiply-adds). Nearest sampling runs 2 iterations: from the third on, the
states differ by enough (~1e-6) that a pixel within that distance of a
rounding boundary samples its neighbour in one version and not the other,
which moves the cost by ~5e-4 (measured on an H100).
"""

import numpy as np
import pytest
import torch

from phovo_tpu_torch.ops import fused_batch as FB
from phovo_tpu_torch.ops import pyramid as pyr
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.fused import pack_geometry, pack_target
from phovo_tpu_torch.utils.synthetic import make_sequence

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA GPU"),
]

INTR = Intrinsics(128.0, 128.0, 63.5, 47.5)


@pytest.mark.parametrize("sampling,iterations,threshold", [
    ("nearest", 2, 0.0),
    ("bilinear", 8, 0.0),
    ("bilinear", 8, 200.0),
])
def test_kernel_matches_plain(sampling, iterations, threshold):
    H, W = 96, 128
    I, D, _, _ = make_sequence(INTR, (H, W), 6)
    dev = torch.device("cuda")
    It = torch.from_numpy(np.stack(I)).to(dev)
    Dt = torch.from_numpy(np.stack(D)).to(dev)
    t_all = pack_target(It, pyr.scharr(It, "x", 0.0625), pyr.scharr(It, "y", 0.0625))
    args = (
        It[:-1].reshape(5, -1).contiguous(),
        pack_geometry(Dt[:-1], INTR, 0.3, 5.0).contiguous(),
        t_all[1:].contiguous(), INTR, torch.zeros((5, 6), device=dev),
        iterations, threshold, 1.0,
    )
    before = FB.LAUNCHES
    k = FB.fused_gn_level_batch(*args, H=H, W=W, sampling=sampling)
    assert FB.LAUNCHES == before + 1
    p = FB.fused_gn_level_batch_reference(*args, H=H, W=W, sampling=sampling)
    assert FB.LAUNCHES == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(k.state, p.state, rtol=0, atol=2e-4)
    assert torch.equal(k.iterations, p.iterations)
    assert torch.equal(k.num_valid, p.num_valid)
    torch.testing.assert_close(k.cost, p.cost, rtol=1e-4, atol=0)
    assert float(k.band_masked.abs().sum()) == 0.0
