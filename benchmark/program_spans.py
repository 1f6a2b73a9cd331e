"""The program's own spans in a traced window: for each `phovo.*` span
name the program writes (phovo_tpu_torch/utils/profiling.span), its host
self time, the kernels launched from that self time, their device time and
the device's idle time while the host was in it.

The rules are frozen here, beside benchmark/tracing.py's reduce, so that
the yardstick does not move with the program:

  * a span's self time is its interval, clipped to the window, less the
    intervals of the `phovo.*` spans nested in it on the same host thread;
  * a kernel belongs to the span whose self time holds its launching
    runtime call on that call's thread, the kernel and its launch joined by
    the Chrome trace's `correlation`; a kernel launched outside every
    `phovo.*` span counts under OUTSIDE, and one with no launch in the
    trace under UNATTRIBUTED, never guessed;
  * idle time is the exact intersection of a span's self intervals with
    the window's device-idle intervals (the complement of the union of its
    kernel, copy and set intervals, as reduce takes it).
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from benchmark.tracing import DEVICE_CATEGORIES, WINDOW_SPAN, union

PREFIX = "phovo."
OUTSIDE = "outside"
UNATTRIBUTED = "unattributed"
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def _thread(e):
    return e.get("pid"), e.get("tid")


def _correlation(e):
    return (e.get("args") or {}).get("correlation")


def _self_intervals(spans) -> list:
    """One thread's spans (lo, hi, name) -> their self intervals (a, b,
    name), sorted: each span less the spans nested in it. They are
    disjoint."""
    out, stack = [], []
    for lo, hi, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][1] <= lo:
            stack.pop()
        if stack:
            stack[-1][3].append((lo, min(hi, stack[-1][1])))
        stack.append((lo, hi, name, []))
        out.append(stack[-1])
    parts = []
    for lo, hi, name, children in out:
        at = lo
        for a, b in children:  # in order of start, and disjoint
            if a > at:
                parts.append((at, a, name))
            at = max(at, b)
        if hi > at:
            parts.append((at, hi, name))
    return sorted(parts)


def _overlaps(intervals, cuts) -> list[float]:
    """For each of a sorted list of disjoint intervals, the length of its
    intersection with a sorted list of disjoint cuts."""
    out, j = [], 0
    for lo, hi in intervals:
        while j < len(cuts) and cuts[j][1] <= lo:
            j += 1
        total, k = 0.0, j
        while k < len(cuts) and cuts[k][0] < hi:
            total += min(hi, cuts[k][1]) - max(lo, cuts[k][0])
            k += 1
        out.append(total)
    return out


def attribute(events) -> dict:
    """For each `phovo.*` span name in the traced window: spans (how many
    lie in it), host_s (self time), launches and device_s (the kernels
    launched from that self time and their device time) and idle_s (device
    idle time during that self time), in seconds; OUTSIDE and UNATTRIBUTED
    the launches and device_s of the kernels launched outside every span
    and of those whose launch the trace lacks. Empty without a window."""
    window = [e for e in events if e.get("name") == WINDOW_SPAN and e.get("cat") == "user_annotation"]
    if not window:
        return {}
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0].get("dur", 0.0))

    spans = defaultdict(list)
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name.startswith(PREFIX) and "ts" in e:
            lo = float(e["ts"])
            hi = lo + float(e.get("dur", 0.0))
            if hi > w0 and lo < w1:
                spans[_thread(e)].append((max(lo, w0), min(hi, w1), name))
    selves = {thread: _self_intervals(s) for thread, s in spans.items()}

    dev = [e for e in events if e.get("cat") in DEVICE_CATEGORIES and "ts" in e and w0 <= float(e["ts"]) < w1]
    merged = union([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in dev])
    idle, prev = [], w0
    for lo, hi in merged + [[w1, w1]]:
        if lo > prev:
            idle.append((prev, lo))
        prev = max(prev, hi)

    out = defaultdict(lambda: {"spans": 0, "host_s": 0.0, "launches": 0, "device_s": 0.0, "idle_s": 0.0})
    for s in spans.values():
        for _, _, name in s:
            out[name]["spans"] += 1
    for parts in selves.values():
        for (a, b, name), gap in zip(parts, _overlaps([(a, b) for a, b, _ in parts], idle)):
            out[name]["host_s"] += b - a
            out[name]["idle_s"] += gap

    launch = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATEGORIES and _correlation(e) is not None and "ts" in e:
            launch[_correlation(e)] = (float(e["ts"]), _thread(e))
    starts = {thread: [a for a, _, _ in parts] for thread, parts in selves.items()}
    rest = {OUTSIDE: {"launches": 0, "device_s": 0.0}, UNATTRIBUTED: {"launches": 0, "device_s": 0.0}}
    for e in dev:
        if e["cat"] != "kernel":
            continue
        found = launch.get(_correlation(e))
        if found is None:
            row = rest[UNATTRIBUTED]
        else:
            t, thread = found
            parts = selves.get(thread, [])
            i = bisect.bisect_right(starts.get(thread, []), t) - 1
            row = out[parts[i][2]] if i >= 0 and t < parts[i][1] else rest[OUTSIDE]
        row["launches"] += 1
        row["device_s"] += float(e.get("dur", 0.0))
    rows = dict(sorted(out.items()), **rest)
    return {name: {k: (v * 1e-6 if k.endswith("_s") else v) for k, v in row.items()} for name, row in rows.items()}
