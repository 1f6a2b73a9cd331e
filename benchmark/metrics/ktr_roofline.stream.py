"""K-TR's share of its roofline, from the trace."""

from benchmark.metrics import common

read = common.roofline_pct("tr")
