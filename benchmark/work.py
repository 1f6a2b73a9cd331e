"""The yardstick of the level kernels: the card's peaks and the work a
launch does, counted from its inputs' shapes and the iterations its pairs
actually ran.

A copy of chip_smoke.py's arithmetic (H100_BYTES_PER_S, H100_F32_FLOPS,
GN_FLOPS, nbytes and bound), frozen here so that a change to the program
cannot change what its kernels are measured against. Each level kernel's
operation count is a file of its own, benchmark/kernels/<model>.py, found
by the name a configuration file gives it.
"""

from __future__ import annotations

import importlib
import re

# NVIDIA's H100 SXM data sheet, dense, at 700 W: device memory bytes/s and
# float32 operations/s outside the tensor cores. Both level kernels are
# float32 CUDA-core work.
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12

# float32 operations of one linearization of one pixel (compares,
# selects, index arithmetic and rounding not counted), from the kernels'
# per-pixel code (csrc/phovo_linearize.cuh accumulate_pixel): warp 25,
# rotation-derivative rows 34, chain terms 22, residual and columns 22,
# Gram, J^T r, cost and count 57; bilinear sampling of the three target
# channels 40 more.
GN_FLOPS = {"nearest": 160, "bilinear": 200}

# float32 values a pixel of a pair reads: the source intensity, the four
# geometry rows (px, py, pz, depth in range) and the target's three
# channels (I, gx, gy)
PIXEL_FLOATS = 1 + 4 + 3
# float32 values a pair reads and writes outside its pixels: the state in,
# the state out and the six diagnostics out
PAIR_FLOATS = 6 + 6 + 6


def launch_bytes(pairs: int, pixels: int) -> int:
    """Bytes one level launch of `pairs` pairs at `pixels` a pair moves,
    each input read once and each output written once."""
    return 4 * pairs * (pixels * PIXEL_FLOATS + PAIR_FLOATS)


def least_seconds(n_bytes: float, flops: float) -> tuple[float, str]:
    """(the least time the card could take, what sets it): the larger of
    the bytes over the memory rate and the operations over the float32
    rate."""
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_model(name: str):
    """The work model of a level kernel, benchmark/kernels/<name>.py, as a
    configuration file's program.level_kernels names it: its flops(pairs,
    iterations, pixels, sampling), `iterations` the sum over a launch's
    pairs."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"no kernel work model named {name!r}")
    return importlib.import_module(f"benchmark.kernels.{name}")


def call_work(model: str, iterations, shape, sampling: str, max_iterations) -> list[tuple[int, float]]:
    """(bytes, flops) of each level launch of one aligning call by the
    kernel whose work model is `model`: iterations is the call's (B, L)
    per-pair, per-level count (numpy), shape the frames' (H, W); a level
    with no budget launches nothing."""
    flops = kernel_model(model).flops
    out = []
    B, L = iterations.shape
    for level in range(L):
        if max_iterations[level] <= 0:
            continue
        f = 2 ** level
        pixels = int(round(shape[0] / f)) * int(round(shape[1] / f))
        out.append((launch_bytes(B, pixels), flops(B, int(iterations[:, level].sum()), pixels, sampling)))
    return out
