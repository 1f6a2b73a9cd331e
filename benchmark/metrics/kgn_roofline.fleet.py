"""K-GN's share of its roofline at B = cameras, from the trace."""

from benchmark.metrics import common

read = common.roofline_pct("gn")
