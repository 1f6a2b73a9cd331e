#!/usr/bin/env python3
"""Where K-GN's cost differs from the plain version's on the card test
`test_kernel_matches_plain[bilinear-8-0.0]` (tests/test_torch_kernel_cuda.py:
five 96x128 pairs of make_sequence, 8 bilinear iterations from zero), at
every cluster size the C entry takes (1, 2, 4, 8).

    python3 tools/gn_cost_attribution.py

A GN level's cost is its last linearization's, at the state after 7 of
the 8 iterations (x7). For each pair and cluster size it prints:
  * the cost's relative difference, kernel against plain;
  * x7's difference, in absolute terms and in float32 ulps of the state;
  * that difference split in two: the order of the sums (the kernel's cost
    against the plain version's at the kernel's own x7) and the state (the
    plain version's cost at the kernel's x7 against at its own);
  * the cost along the straight segment from the plain version's x7 to the
    kernel's, in float64 at 9 points: a jump in the cost shows as one step
    carrying most of the change, a smooth cost as 8 steps of about 1/8;
  * the pixels whose bilinear cell (floor u, floor v) or validity differs
    between the two x7 (the sampler's only branches), and the share of the
    state part carried by the ten pixels that move most.
And, as a control with no kernel in it, the plain version on the CPU
against the plain version on the card: the same code, its sums in another
order. Needs an NVIDIA GPU and nvcc. Prints the card's name and power
limit.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CLUSTERS = (1, 2, 4, 8)
H, W, ITERATIONS = 96, 128, 8


def chip_smoke():
    """chip_smoke.py as a module (it runs its phases only as a script)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_case(dev):
    """test_kernel_matches_plain's bilinear case: (packs and intrinsics,
    zero states) and the wrapper's keywords."""
    from phovo_tpu_torch.ops import pyramid as pyr
    from phovo_tpu_torch.ops.camera import Intrinsics
    from phovo_tpu_torch.ops.fused import pack_geometry, pack_target
    from phovo_tpu_torch.utils.synthetic import make_sequence

    intr = Intrinsics(128.0, 128.0, 63.5, 47.5)
    I, D, _, _ = make_sequence(intr, (H, W), 6)
    It = torch.from_numpy(np.stack(I)).to(dev)
    Dt = torch.from_numpy(np.stack(D)).to(dev)
    t_all = pack_target(It, pyr.scharr(It, "x", 0.0625), pyr.scharr(It, "y", 0.0625))
    packs = (It[:-1].reshape(5, -1).contiguous(), pack_geometry(Dt[:-1], intr, 0.3, 5.0).contiguous(),
             t_all[1:].contiguous(), intr, torch.zeros((5, 6), device=dev))
    return packs, dict(H=H, W=W, sampling="bilinear")


def ulps(x: torch.Tensor) -> torch.Tensor:
    """float32 spacing at |x|."""
    a = x.abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    from phovo_tpu_torch.ops import _build
    from phovo_tpu_torch.ops import fused_batch as fb

    smoke = chip_smoke()
    dev = torch.device("cuda", 0)
    packs, kw = test_case(dev)
    i0, geom, t_all, intr, zero = packs
    fn, names = getattr(_build.library(), smoke.LEVEL_ENTRIES["gn"][1]), smoke.entry_names("gn")

    def kernel(iterations, cluster):
        run, states, diag = smoke.entry_launcher(fn, names, "gn", (*packs, iterations, 0.0, 1.0), kw, cluster)
        run()
        torch.cuda.synchronize()
        return states.clone(), diag[:, 2].clone()

    def plain(init, iterations):
        return fb.fused_gn_level_batch_reference(i0, geom, t_all, intr, init, iterations, 0.0, 1.0, **kw)

    def pixels(states, dtype=torch.float32):
        """Each pixel's residual, bilinear cell and validity, the residuals
        computed in dtype."""
        cols = [states[:, k:k + 1].to(dtype) for k in range(6)]
        _, r, valid, _ = fb._pixel_columns(cols, geom.to(dtype).unbind(1), i0.to(dtype),
                                           t_all.reshape(5, 3, H * W).to(dtype), intr, H, W, True)
        u, v, _ = smoke.warped_uv(fb, geom, states, tuple(intr), H, W, "bilinear")
        return r, valid, torch.floor(u), torch.floor(v)

    def segment(a, b, points=9):
        """(points, 5) float64 costs on the straight segment from states a
        to states b."""
        ts = torch.linspace(0.0, 1.0, points, dtype=torch.float64, device=dev)
        return torch.stack([(pixels(a.double() + t * (b.double() - a.double()), torch.float64)[0] ** 2).sum(dim=1)
                            for t in ts])

    p8, x7p = plain(zero, ITERATIONS), plain(zero, ITERATIONS - 1).state
    rp, vp, cp, rowp = pixels(x7p)
    cpu = fb.fused_gn_level_batch_reference(*(t.cpu() if torch.is_tensor(t) else t for t in packs), ITERATIONS,
                                            0.0, 1.0, **kw)
    print(f"plain: costs {p8.cost.tolist()}, ||J^T r|| {p8.gradient_norm.tolist()}, valid {p8.num_valid.tolist()} "
          f"[{card}]")
    print(f"control, the plain version on the CPU against on the card: cost rel diff "
          f"{((cpu.cost - p8.cost.cpu()) / p8.cost.cpu()).tolist()}, max|state diff| "
          f"{float((cpu.state - p8.state.cpu()).abs().max()):.3e} [{card}]")
    for c in CLUSTERS:
        _, cost_k = kernel(ITERATIONS, c)
        x7k, _ = kernel(ITERATIONS - 1, c)
        at_k = plain(x7k, 1).cost
        dx = x7k - x7p
        rk, vk, ck, rowk = pixels(x7k)
        flips = ((ck != cp) | (rowk != rowp)) & (vk > 0) & (vp > 0) | (vk != vp)
        moved = (rk * rk - rp * rp).abs()
        top10 = moved.topk(10, dim=1).values.sum(dim=1) / moved.sum(dim=1).clamp_min(1e-30)
        costs = segment(x7p, x7k)
        change = costs[-1] - costs[0]
        largest = (costs[1:] - costs[:-1]).abs().max(dim=0).values / change.abs().clamp_min(1e-300)
        for b in range(5):
            total = float((cost_k[b] - p8.cost[b]) / p8.cost[b])
            order = float((cost_k[b] - at_k[b]) / at_k[b])
            state = float((at_k[b] - p8.cost[b]) / p8.cost[b])
            print(f"C = {c} pair {b}: cost rel diff {total:+.3e} = order of the sums {order:+.3e} + state "
                  f"{state:+.3e}; in float64 the state moves the cost by {float(change[b] / costs[0, b]):+.3e}, "
                  f"its largest of 8 steps {float(largest[b]):.3f} of that; x7 max|diff| "
                  f"{float(dx[b].abs().max()):.3e}, {float((dx[b].abs() / ulps(x7p[b])).max()):.1f} ulps; cells or "
                  f"validity flipped {int(flips[b].sum())}; top-10 pixels' share of the state part "
                  f"{float(top10[b]):.3f} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
