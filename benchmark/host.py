"""The host's and the card's state beside a run, read and never set: the
1-minute load average, the process's CPU affinity, the CPU it last ran
on and the current frequency of its CPUs (from /proc and /sys), and the
card's SM clock (nvidia-smi). A run's line carries them under "host",
which no metric reads: they tell a loaded host or a slow clock apart
from the program when two runs differ."""

from __future__ import annotations

import os
import subprocess


def _read(path: str) -> str | None:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def cpu_mhz(cpus) -> dict[int, float]:
    """Each CPU's current frequency in MHz: cpufreq's scaling_cur_freq,
    else /proc/cpuinfo's "cpu MHz"; {} where neither says."""
    out = {}
    for c in cpus:
        khz = _read(f"/sys/devices/system/cpu/cpu{c}/cpufreq/scaling_cur_freq")
        if khz is not None:
            out[c] = int(khz) / 1e3
    if out:
        return out
    at = None
    for line in (_read("/proc/cpuinfo") or "").splitlines():
        if line.startswith("processor"):
            at = int(line.split(":")[1])
        elif line.startswith("cpu MHz") and at in cpus:
            out[at] = float(line.split(":")[1])
    return out


def ranges(cpus) -> str:
    """Sorted CPU numbers as a list of ranges: [0, 1, 2, 5] -> "0-2,5"."""
    parts, start, prev = [], None, None
    for c in list(cpus) + [None]:
        if start is not None and c != prev + 1:
            parts.append(f"{start}-{prev}" if prev > start else f"{start}")
            start = None
        if start is None:
            start = c
        prev = c
    return ",".join(parts)


def card_id(device) -> str | None:
    """The card `device` is, as nvidia-smi names it: its UUID.
    nvidia-smi numbers the host's cards and not the process's visible
    ones, so an index would read another card where CUDA_VISIBLE_DEVICES
    picks one."""
    import torch

    uuid = getattr(torch.cuda.get_device_properties(device), "uuid", None)
    if uuid is None:
        return None
    uuid = str(uuid)
    return uuid if uuid.startswith("GPU-") else f"GPU-{uuid}"


def sm_clock_mhz(device) -> float | None:
    """The SM clock of the card `device` now, or None where nvidia-smi
    cannot say."""
    card = card_id(device)
    if card is None:
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-i", card],
                             capture_output=True, text=True, timeout=20).stdout.strip()
        return float(out)
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def state(device) -> dict:
    """The host's state now, and the SM clock of `device` where it is a
    card."""
    load = (_read("/proc/loadavg") or "nan").split()[0]
    cpus = sorted(os.sched_getaffinity(0))
    stat = _read("/proc/self/stat")
    cpu = int(stat.rsplit(")", 1)[1].split()[36]) if stat else None
    mhz = cpu_mhz(cpus)
    return {
        "load1": float(load),
        "affinity": ranges(cpus),
        "cpu": cpu,
        "cpu_mhz": mhz.get(cpu),
        "cpu_mhz_mean": sum(mhz.values()) / len(mhz) if mhz else None,
        "sm_mhz": sm_clock_mhz(device) if device.type == "cuda" else None,
    }
