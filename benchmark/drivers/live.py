"""live: one camera, open loop at the mix's frame rate, in frame mode
through the object API (benchmark/drivers/__init__.py)."""

from __future__ import annotations

import math
import time

import numpy as np

from benchmark.drivers import Chain, Program, integrate, tick, wait_until
from benchmark.tracing import span


def drive(prog: Program, seq, mix: dict, seconds: float, tracer, rng) -> dict:
    """One camera at mix["fps"], open loop, from a seeded offset in the
    sequence: pair k (frame k-1 to frame k) is due k frame periods after
    the window opens and is handled then, or at once when the pair before
    ends late; its latency runs from its due time to its pose on the host.
    Frames come as a camera driver hands them: uint8 intensity and float32
    depth in metres, converted at set-up for the frames the run uses."""
    I8, D16 = seq
    N, fps = len(I8), float(mix["fps"])
    vo = prog.object_api()
    offset = int(rng.integers(N))
    n_pairs = math.ceil(seconds * fps)
    warm = 4
    frames = [(offset + k) % N for k in range(-warm, n_pairs + 1)]
    depth_m = {f: D16[f].astype(np.float32) * np.float32(prog.depth_scale) for f in set(frames)}

    def pair(src, tgt, init):
        with span(tracer, "set frames"):
            vo.set_source_frame(I8[src], depth_m[src])
            vo.set_target_frame(I8[tgt], depth_m[tgt])
            vo.set_initial_state_vector(init)
        with span(tracer, "optimize"):
            res = vo.optimize()
        return res

    zero = np.zeros(6, np.float32)
    for k in range(warm):
        pair(frames[k], frames[k + 1], zero).state.cpu()
    frames = frames[warm:]
    chain, calls, latencies = Chain(), [], []
    t_start = time.perf_counter()
    t_end = t_start + seconds
    for k in range(1, n_pairs + 1):
        due = t_start + k / fps
        if due >= t_end:
            break
        tick(tracer, time.perf_counter(), t_start)
        with span(tracer, "frame wait"):
            wait_until(due)
        now = time.perf_counter()
        res = pair(frames[k - 1], frames[k], zero)
        with span(tracer, "pose integrate"):
            state = res.state.cpu().numpy()
            poses, chain.pose = integrate(chain.pose, state[None])
        done = time.perf_counter()
        latencies.append(done - due)
        calls.append({"t": now, "frames": 1, "iterations": res.iterations})
        chain.add([(frames[k - 1], frames[k])], state, poses, res.iterations, res.num_valid)
    return {"t_start": t_start, "frames_done": len(latencies), "chains": [chain], "calls": calls,
            "attempted": len(latencies), "missing": 0, "latencies": latencies}
