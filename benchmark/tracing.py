"""The traced part of a `--trace 1` run: a torch.profiler window over a
stretch of the measured window, reduced to device events, the harness's
spans and a breakdown.

The reduction copies phovo_tpu_torch/utils/profiling.trace_summary's
arithmetic (device busy time is the union of the kernel, copy and set
intervals of the Chrome trace), frozen here so that the yardstick does
not move with the program.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "traced window"


def span(tracer, name: str):
    """A harness span around a call into the program: a profiler
    annotation while the trace runs, nothing otherwise."""
    if tracer is not None and tracer.active:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


class Tracer:
    """Starts the profiler trace_lead_s into the measured window and stops
    it trace_seconds later, at the driver's ticks between calls; the card
    is drained at both ends, so the traced calls' device work lies inside
    the trace and no other call's does."""

    def __init__(self, lead_s: float, seconds: float, device):
        self.lead_s, self.seconds, self.device = lead_s, seconds, device
        self.prof = None
        self.active = False
        self.t0 = self.t1 = None
        self._window = None
        self.events = None
        # the profiler's first window pays for setting up its tracing of
        # the card (seconds): paid here, in set-up, and not in the window
        with torch.profiler.profile(activities=self._activities()):
            x = torch.ones(64, device=device)
            (x + x).sum().item()

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def tick(self, now: float, t_start: float) -> None:
        if self.t0 is None and now >= t_start + self.lead_s:
            self.start()
        elif self.active and now >= self.t0 + self.seconds:
            self.stop()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self.prof = torch.profiler.profile(activities=self._activities())
        self.prof.start()
        self.active = True
        self._window = torch.profiler.record_function(WINDOW_SPAN)
        self._window.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if not self.active:
            return
        self._sync()
        self.t1 = time.perf_counter()
        self._window.__exit__(None, None, None)
        self.prof.stop()
        self.active = False
        tmp = Path(tempfile.mkdtemp(prefix="bench_trace_"))
        try:
            path = tmp / "trace.json"
            self.prof.export_chrome_trace(str(path))
            self.events = json.loads(path.read_text()).get("traceEvents", [])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self.prof = None

    def in_trace(self, t: float) -> bool:
        return self.t0 is not None and self.t1 is not None and self.t0 <= t < self.t1


def union(spans):
    """Merged [lo, hi) intervals of a list of (lo, hi)."""
    merged = []
    for lo, hi in sorted(spans):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameter list."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ").strip()
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0), default=len(name))
    return name[:cut].strip() or name


def reduce(events, spans_of_interest) -> dict:
    """What the trace shows, in seconds: the traced window's bounds and
    length, the device events inside it (category, name, start, duration),
    the union of their intervals, and the breakdown: the device operations
    that took most time, and the device's idle time by the harness span the
    host was in (the innermost one around each gap's middle)."""
    window = [e for e in events if e.get("name") == WINDOW_SPAN and e.get("cat") == "user_annotation"]
    if not window:
        return {}
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0].get("dur", 0.0))
    dev = [(e["cat"], e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
           for e in events if e.get("cat") in DEVICE_CATEGORIES and "ts" in e]
    dev = [d for d in dev if w0 <= d[2] < w1]
    merged = union([(ts, ts + dur) for _, _, ts, dur in dev])
    busy = sum(min(hi, w1) - lo for lo, hi in merged)
    by_name = defaultdict(float)
    for cat, name, _, dur in dev:
        by_name[short_name(name) if cat == "kernel" else name] += dur
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                   for e in events if e.get("cat") == "user_annotation" and e.get("name") in spans_of_interest),
                  key=lambda s: s[1] - s[0])
    gaps, prev = [], w0
    for lo, hi in merged + [[w1, w1]]:
        if lo > prev:
            gaps.append((prev, lo))
        prev = max(prev, hi)
    idle = defaultdict(float)
    for lo, hi in gaps:
        mid = 0.5 * (lo + hi)
        label = next((n for a, b, n in host if a <= mid < b), "outside the harness's spans")
        idle[label] += hi - lo
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy * 1e-6,
        "device_events": [(cat, name, ts * 1e-6, dur * 1e-6) for cat, name, ts, dur in dev],
        "breakdown": {
            "device_ops": [[n, v * 1e-6] for n, v in top],
            "idle_gaps": [[n, v * 1e-6] for n, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        },
    }
