"""K-GN's work (csrc/fused_gn_batch.cu): one linearization of every pixel
per Gauss-Newton iteration."""

from benchmark.work import GN_FLOPS


def flops(pairs: int, iterations: int, pixels: int, sampling: str) -> float:
    del pairs
    return float(iterations) * pixels * GN_FLOPS[sampling]
