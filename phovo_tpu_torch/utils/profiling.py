"""Timers, the profiler trace and per-frame metrics (torch port of
phovo_tpu/utils/profiling.py).

  - Stopwatch: accumulating host wall clock; stop(*tensors) first waits
    for the CUDA devices those tensors live on (the counterpart of
    jax.block_until_ready), so an interval covers their device work;
  - span(name): the program's own spans (phovo.upload, phovo.align,
    phovo.prep, phovo.level): a torch.profiler annotation while a
    profiler runs, so they land in its trace on its clock beside the
    kernels they launched, and one shared null context otherwise;
  - trace(log_dir): a torch.profiler window (with the card's activity
    where there is a card) exported as a Chrome trace into log_dir, and
    trace_summary of it: kernel launches, device-busy and wall ms;
  - MetricsLogger: JSON lines, one object a frame (phovo-vo --metrics).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch


def _cuda_devices(items, found: set) -> set:
    for x in items:
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                found.add(x.device)
        elif isinstance(x, (tuple, list)):
            _cuda_devices(x, found)
        elif isinstance(x, dict):
            _cuda_devices(x.values(), found)
    return found


class Stopwatch:
    """Accumulating wall-clock timer that waits for the devices of the
    tensors given to stop() before it reads the clock."""

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, *sync_tensors):
        """Seconds since start(), after every CUDA device that holds one
        of sync_tensors (tensors, or tuples, lists and dicts of them)
        finished its queued work; added to total."""
        for device in _cuda_devices(sync_tensors, set()):
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - self._t0
        self.total += dt
        self.count += 1
        return dt

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """with span("phovo.prep"): ... marks the block in the trace of the
    torch profiler that runs (profiling.trace, or any other window), as a
    user annotation named `name`; a span inside another on the same thread
    is its child. With no profiler running it returns one shared null
    context: no allocation and no clock read."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@dataclasses.dataclass
class TraceWindow:
    """A finished profiler window: the profile, the Chrome trace written
    from it, and the host wall time of the window (ms, the card
    synchronized at its end)."""

    profile: torch.profiler.profile | None = None
    path: Path | None = None
    wall_ms: float = 0.0


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """with trace(dir) as window: ... profiles the block with
    torch.profiler (CPU activity, and the card's where there is one),
    waits for the card at its end and writes the Chrome trace to
    dir/trace.json (open it in Perfetto or chrome://tracing)."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    window = TraceWindow()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield window
        if cuda:
            torch.cuda.synchronize()
        window.wall_ms = (time.perf_counter() - t0) * 1e3
    window.profile = prof
    window.path = log_dir / "trace.json"
    prof.export_chrome_trace(str(window.path))


# Chrome-trace categories of device work: kernels, and copies and sets
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_summary(window: TraceWindow) -> dict:
    """What a profiler window's trace shows: kernel_launches (device
    kernels run), device_busy_ms (the union of the device's kernel, copy
    and set intervals) and wall_ms (the window's host wall time)."""
    events = json.loads(Path(window.path).read_text()).get("traceEvents", [])
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in events if e.get("cat") in DEVICE_CATEGORIES and "ts" in e)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return {
        "kernel_launches": sum(1 for e in events if e.get("cat") == "kernel"),
        "device_busy_ms": busy / 1e3,
        "wall_ms": window.wall_ms,
    }


def _to_jsonable(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return v.item() if v.ndim == 0 else v.tolist()
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v


class MetricsLogger:
    """Append-only JSONL metrics stream: one object a log() call, with the
    wall-clock time added unless given, flushed line by line."""

    def __init__(self, path: str | Path):
        self._f = open(path, "a")

    def log(self, **fields) -> None:
        record = {k: _to_jsonable(v) for k, v in fields.items()}
        record.setdefault("time", time.time())
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
