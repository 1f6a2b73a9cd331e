"""K-TR's work (csrc/fused_tr_batch.cu): one linearization of every pixel
at the start state and one at every trial step, rejected steps
included."""

from benchmark.work import GN_FLOPS


def flops(pairs: int, iterations: int, pixels: int, sampling: str) -> float:
    return float(pairs + iterations) * pixels * GN_FLOPS[sampling]
