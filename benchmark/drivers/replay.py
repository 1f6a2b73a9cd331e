"""replay: the sequence in chunks through the chunked entry, closed loop,
as `phovo-vo --chunk N` runs it (benchmark/drivers/__init__.py)."""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from benchmark.drivers import Chain, Program, integrate, tick, to_device
from benchmark.tracing import span


def drive(prog: Program, seq, mix: dict, seconds: float, tracer, rng) -> dict:
    """The sequence in chunks of mix["chunk"] new frames, closed loop, for
    `seconds`; every shape is warmed up by one whole pass first. Counts the
    frames whose poses reached the host inside the window."""
    del rng
    I8, D16 = seq
    N, chunk = len(I8), int(mix["chunk"])
    fn = prog.chunk_entry()
    dev, scale = prog.device, prog.depth_scale
    bounds = [(a, min(a + chunk, N)) for a in range(1, N, chunk)]

    def settle(rec, t_end):
        res, chain, lo, hi = rec
        with span(tracer, "pose integrate"):
            states = res.state.cpu().numpy()
            poses, chain.pose = integrate(chain.pose, states)
        done = time.perf_counter()
        chain.add([(k - 1, k) for k in range(lo, hi)], states, poses, res.iterations, res.num_valid)
        return hi - lo if t_end is None or done <= t_end else 0

    def run(t_start, t_end):
        """Chunks until t_end, or one pass when t_end is None."""
        chains, calls, counted, pending, carry, chain = [], [], 0, None, None, None
        for i in itertools.count():
            lo, hi = bounds[i % len(bounds)]
            now = time.perf_counter()
            if (t_end is None and i == len(bounds)) or (t_end is not None and now >= t_end):
                break
            tick(tracer, now, t_start)
            now = time.perf_counter()
            if lo == 1:  # a new pass: a new carry, a new chain of poses
                chain = Chain()
                chains.append(chain)
                carry = (to_device(I8[0], dev), to_device(D16[0], dev).to(torch.float32) * float(np.float32(scale)))
            with span(tracer, "copy"):
                Ii, Dd = to_device(I8[lo:hi], dev), to_device(D16[lo:hi], dev)
            with span(tracer, "align call"):
                res, *carry = fn(*carry, Ii, Dd, scale)
            calls.append({"t": now, "frames": hi - lo, "iterations": res.iterations})
            if pending is not None:
                counted += settle(pending, t_end)
            pending = (res, chain, lo, hi)
        if pending is not None:
            counted += settle(pending, t_end)
        return counted, chains, calls

    run(None, None)
    t_start = time.perf_counter()
    counted, chains, calls = run(t_start, t_start + seconds)
    return {"t_start": t_start, "frames_done": counted, "chains": chains, "calls": calls,
            "attempted": sum(c["frames"] for c in calls), "missing": 0, "latencies": None}
