"""What the metric readers share. A reader is benchmark/metrics/<metric>.py
with read(record) -> float | None, where record is what run.run_cell
returns; None leaves the metric out of the run's line (nothing to read).
The per-layer readers read record["trace"]: the traced window's device
events (category, name, start, seconds), its length and busy time, the
frames the traced calls carried, and for each level kernel the
configuration file names (by its work model, benchmark/kernels/<model>.py)
its name in the trace and the (bytes, operations) of each launch those
calls made."""

from __future__ import annotations

import math

from benchmark import work


def _trace(record):
    t = record.get("trace")
    return t if t and t.get("frames") else None


def _kernel_seconds(t, name=None):
    return sum(dur for cat, n, _, dur in t["device_events"]
               if cat == "kernel" and (name is None or name in n))


def frames_per_s(record):
    if record.get("latencies") is not None or not record.get("frames_done"):
        return None
    return record["frames_done"] / record["seconds"]


def latency_p95_ms(record):
    lat = record.get("latencies")
    if not lat:
        return None
    ranked = sorted(lat)
    return 1e3 * ranked[math.ceil(0.95 * len(ranked)) - 1]


def copy_ms_per_frame(record):
    """Device time of the host-to-device copies a frame."""
    t = _trace(record)
    if t is None:
        return None
    s = sum(dur for cat, n, _, dur in t["device_events"] if cat == "gpu_memcpy" and "HtoD" in n)
    return 1e3 * s / t["frames"] if s > 0 else None


def launches_per_frame(record):
    t = _trace(record)
    if t is None:
        return None
    n = sum(1 for cat, *_ in t["device_events"] if cat == "kernel")
    return n / t["frames"] if n else None


def prep_ms_per_frame(record):
    """Device time a frame of the kernels that are neither level kernels
    nor copies: storage-dtype conversion, pyramids, gradients, packs."""
    t = _trace(record)
    if t is None:
        return None
    level = [k["name"] for k in t["kernels"].values()]
    s = sum(dur for cat, n, _, dur in t["device_events"] if cat == "kernel" and not any(k in n for k in level))
    return 1e3 * s / t["frames"] if s > 0 else None


def roofline_pct(model: str):
    """The share of its roofline of the level kernel whose work model is
    `model`: the least time of each of its traced launches
    (work.least_seconds of its bytes and operations) summed, over the
    device time of its kernels in the trace, in %."""

    def read(record):
        t = _trace(record)
        kernel = t and t["kernels"].get(model)
        if not kernel or not kernel["launches"]:
            return None
        spent = _kernel_seconds(t, kernel["name"])
        least = sum(work.least_seconds(b, f)[0] for b, f in kernel["launches"])
        return 100.0 * least / spent if spent > 0 and least > 0 else None

    return read


def device_idle_pct(record):
    t = _trace(record)
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def step_mfu(record):
    """The traced window's counted level-kernel operations over the card's
    float32 peak for the window's length, in %: the whole step's share of
    the chip, which bounds what any kernel's gain can show end to end."""
    t = _trace(record)
    if t is None or t["window_s"] <= 0:
        return None
    flops = sum(f for k in t["kernels"].values() for _, f in k["launches"])
    return 100.0 * flops / (t["window_s"] * work.H100_F32_FLOPS) if flops > 0 else None
