"""The 95th percentile (nearest rank) of the frames' latencies, due time to pose on the host."""

from benchmark.metrics import common

read = common.latency_p95_ms
