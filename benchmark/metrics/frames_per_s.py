"""Frames whose pose reached the host inside the window, over its length."""

from benchmark.metrics import common

read = common.frames_per_s
