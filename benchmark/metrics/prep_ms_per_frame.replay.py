"""Prep's device time a frame, from the trace."""

from benchmark.metrics import common

read = common.prep_ms_per_frame
