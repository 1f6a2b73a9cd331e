"""The traced window's level-kernel operations over the card's float32 peak."""

from benchmark.metrics import common

read = common.step_mfu
