"""Prep's device time a camera frame (the per-camera conversions, the
stacking and K-PREP), from the trace."""

from benchmark.metrics import common

read = common.prep_ms_per_frame
