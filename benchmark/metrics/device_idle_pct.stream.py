"""The traced window's share with nothing on the device."""

from benchmark.metrics import common

read = common.device_idle_pct
