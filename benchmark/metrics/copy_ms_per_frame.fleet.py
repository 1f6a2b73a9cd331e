"""Host-to-device copy time a camera frame, from the trace."""

from benchmark.metrics import common

read = common.copy_ms_per_frame
