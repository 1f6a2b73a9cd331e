"""Kernels a frame, from the trace."""

from benchmark.metrics import common

read = common.launches_per_frame
