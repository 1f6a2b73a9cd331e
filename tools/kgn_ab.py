#!/usr/bin/env python3
"""A/B timing of phovo_tpu_torch's Gauss-Newton level kernel (K-GN) from
two source trees on one NVIDIA GPU.

    python3 tools/kgn_ab.py OTHER_TREE

OTHER_TREE is another checkout of the repository (an unpacked `git
archive` of another commit). Compiles phovo_tpu_torch/csrc/fused_gn_batch.cu
of this tree and of OTHER_TREE, each alone into its own library with this
tree's nvcc flags (printing ptxas's register, stack and spill report of
both), and times the photometric level on the same packs, in turns (other,
this, this, other), by CUDA events over repeated launches after a warm-up:
  * the bench chain's three levels: 256 VGA pairs, nearest, 5, 20 and 50
    iterations at 120x160, 60x80 and 30x40;
  * one pair's 480x640 level at B = 1, 3 nearest iterations.
Prints every time with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

REPEATS = 20


def build(tree: Path, out: Path) -> ctypes.CDLL:
    """nvcc fused_gn_batch.cu of tree alone into out; prints ptxas -v."""
    from phovo_tpu_torch.ops import _build

    csrc = tree / "phovo_tpu_torch" / "csrc"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", str(csrc),
           "-o", str(out), str(csrc / "fused_gn_batch.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {tree}:\n{proc.stderr}")
    report = [ln.strip() for ln in proc.stderr.splitlines() if "registers" in ln or "spill" in ln]
    print(f"ptxas {tree.name}: " + " | ".join(report[:4]) + f" ... ({len(report)} lines)")
    lib = ctypes.CDLL(str(out))
    fn = lib.phovo_fused_gn_level_batch
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    source = (csrc / "fused_gn_batch.cu").read_text()
    n_ptr = 8 if "depth_gains" in source else 7
    # the integer arguments after H and W: sampling, loss, esm, and the
    # shared-source flag where the tree has it
    fn.flags = (0, 0, 0, 0) if "shared_source" in source else (0, 0, 0)
    fn.argtypes = [P] * n_ptr + [I] * (3 + len(fn.flags)) + [F] * 4 + [I, F, F, I, P]
    fn.restype = I
    fn.n_ptr = n_ptr
    return fn


def launcher(fn, i0, geom, t_all, intr, init, H, W, iterations):
    B = i0.shape[0]
    scale = torch.full((B,), 0.1, device=i0.device)
    states = torch.empty((B, 6), device=i0.device)
    diag = torch.empty((B, 6), device=i0.device)
    ptrs = [i0.data_ptr(), geom.data_ptr(), t_all.data_ptr(), init.data_ptr(), scale.data_ptr()]
    if fn.n_ptr == 8:
        ptrs.append(None)  # depth_gains: the photometric level
    ptrs += [states.data_ptr(), diag.data_ptr()]
    keep = (scale, diag)  # alive as long as the launcher

    def run():
        assert keep
        err = fn(*ptrs, B, H, W, *fn.flags, intr.fx, intr.fy, intr.cx, intr.cy, iterations, 0.0, 1.0, 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    return run, states


def cuda_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPEATS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPEATS


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    from phovo_tpu_torch.models.analytic import prep_frame_analytic
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.ops.pyramid import level_shape
    from phovo_tpu_torch.utils.config import PhovoConfig
    from phovo_tpu_torch.utils.synthetic import make_pair

    other = Path(sys.argv[1]).resolve()
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out = ROOT / "build" / "phovo_tpu_torch"
    out.mkdir(parents=True, exist_ok=True)
    libs = {"other": build(other, out / "kgn_ab_other.so"), "this": build(ROOT, out / "kgn_ab_this.so")}

    dev = torch.device("cuda", 0)
    I0, D0, I1, D1, _ = make_pair(TUM_FR1, (480, 640))
    Is = torch.from_numpy(np.stack([I0, I1] * 129)[:257]).to(dev)
    Ds = torch.from_numpy(np.stack([D0, D1] * 129)[:257]).to(dev)
    cfg = PhovoConfig(num_levels=5, blur_filter_sizes=(0,) * 5, gradient_scales=(0.0625,) * 5,
                      max_iterations=(3, 0, 5, 20, 50), lambda_steps=(1.0,) * 5, min_gradient_norms=(0.0,) * 5)
    prep = prep_frame_analytic(Is, Ds, TUM_FR1, cfg)
    cases = []
    for level in (2, 3, 4):
        i0, geom, t_all = prep[level]
        cases.append((f"{level_shape((480, 640), level)} x 256 pairs x {cfg.max_iterations[level]} it",
                      (i0[:-1], geom[:-1], t_all[1:].contiguous(), TUM_FR1.at_level(level),
                       torch.zeros((256, 6), device=dev), *level_shape((480, 640), level),
                       cfg.max_iterations[level])))
    i0, geom, t_all = prep[0]
    cases.append(("480x640 x 1 pair x 3 it (B = 1)",
                  (i0[:1].contiguous(), geom[:1].contiguous(), t_all[1:2].contiguous(), TUM_FR1,
                   torch.zeros((1, 6), device=dev), 480, 640, 3)))
    totals = {"other": [], "this": []}
    for name, args in cases:
        runs = {key: launcher(fn, *args) for key, fn in libs.items()}
        times = {key: [] for key in libs}
        for key in ("other", "this", "this", "other"):
            times[key].append(cuda_ms(runs[key][0]))
        same = torch.equal(runs["other"][1], runs["this"][1])
        print(f"K-GN {name}: other tree {times['other'][0]:.4f}, {times['other'][1]:.4f} ms; this tree "
              f"{times['this'][0]:.4f}, {times['this'][1]:.4f} ms; same states {same} [{card}]")
        for key in libs:
            totals[key].append(sum(times[key]) / 2)
    print(f"K-GN bench chain (3 levels): other tree {sum(totals['other'][:3]):.4f} ms, this tree "
          f"{sum(totals['this'][:3]):.4f} ms [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
