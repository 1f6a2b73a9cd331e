"""fleet: a fleet of cameras served by one card, one new frame a camera a
round, open loop at the mix's frame rate, as `phovo-serve --chunk 1` runs
it (benchmark/drivers/__init__.py).

The mix gives "cameras" and "fps". Every camera hands over its newest
frame each frame period, all in step: round k is due k periods after the
window opens, and carries camera c's frame (offset_c + k) mod the
sequence's length, the offsets drawn from the seed. The cameras' frames
land in storage dtype (uint8 intensity, uint16 depth counts) in the
round's pinned host buffers, which the driver keeps, as a frame grabber's
DMA buffers would be: round k's frames land as soon as round k-1 has its
poses, and no later than round k's due time. A round copies each buffer
to the card in one copy and calls the configuration's chunk entry
(parallel/batch.serve_sequences_chunk) with every camera's carry frame,
which stays on the card from the round before; the host then fetches the
states and advances each camera's float64 pose. Each camera is one chain
of consecutive pairs, and each camera's frame counts once in the
latencies.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark.drivers import Chain, Program, integrate, tick, to_device, wait_until
from benchmark.tracing import span


class Grabber:
    """The round's host buffers, (cameras, 1, H, W) uint8 intensity and
    uint16 depth counts, page-locked where the device is a card: each
    camera's new frame lands in its row."""

    def __init__(self, seq, cameras: int, device):
        self.I8, self.D16 = seq
        pin = device.type == "cuda"
        shape = (cameras, 1, *self.I8.shape[1:])
        self.intensity = torch.empty(shape, dtype=torch.uint8, pin_memory=pin)
        self.depth = torch.empty(shape, dtype=torch.uint16, pin_memory=pin)
        self.views = self.intensity.numpy()[:, 0], self.depth.numpy()[:, 0]

    def land(self, frames) -> None:
        """Camera c's frame frames[c] arrives, for every camera."""
        for c, f in enumerate(frames):
            np.copyto(self.views[0][c], self.I8[f])
            np.copyto(self.views[1][c], self.D16[f])

    def to(self, device):
        """The buffers on the card, each in one copy (ordered before the
        calls that follow on the current stream)."""
        return (self.intensity.to(device, non_blocking=True, copy=True),
                self.depth.to(device, non_blocking=True, copy=True))


def drive(prog: Program, seq, mix: dict, seconds: float, tracer, rng) -> dict:
    """mix["cameras"] cameras at mix["fps"], open loop: a round is handled
    at its due time, or at once when the round before ends late; its
    latency runs from its due time to every camera's pose on the host."""
    I8, D16 = seq
    N, fps, S = len(I8), float(mix["fps"]), int(mix["cameras"])
    fn = prog.chunk_entry()
    dev, scale = prog.device, prog.depth_scale
    offsets = rng.integers(N, size=S)
    n_rounds = math.ceil(seconds * fps)
    warm = 4

    grabber = Grabber(seq, S, dev)

    def frames(k):
        return (offsets + k) % N

    first = frames(-warm)
    carry = [to_device(I8[first], dev),
             to_device(D16[first], dev).to(torch.float32) * float(np.float32(scale))]

    def serve():
        """A round of the frames that landed: every camera's frame k - 1
        to frame k."""
        with span(tracer, "copy"):
            Ii, Dd = grabber.to(dev)
        with span(tracer, "align call"):
            res, _, *carry[:] = fn(*carry, Ii, Dd, scale)
        return res

    for k in range(-warm + 1, 1):
        grabber.land(frames(k))
        serve().state.cpu()
    chains = [Chain() for _ in range(S)]
    poses = np.broadcast_to(np.eye(4), (S, 4, 4)).copy()
    calls, latencies, answers = [], [], []
    t_start = time.perf_counter()
    t_end = t_start + seconds
    for k in range(1, n_rounds + 1):
        due = t_start + k / fps
        if due >= t_end:
            break
        tick(tracer, time.perf_counter(), t_start)
        with span(tracer, "frame wait"):
            grabber.land(frames(k))
            wait_until(due)
        now = time.perf_counter()
        res = serve()
        with span(tracer, "pose integrate"):
            states = res.state.cpu().numpy()  # (S, 1, 6)
            out, poses = integrate(poses, states)
        done = time.perf_counter()
        latencies += [done - due] * S
        calls.append({"t": now, "frames": S, "iterations": res.iterations})
        answers.append((k, states, out, res.iterations, res.num_valid))
    # each camera's chain, with the diagnostics fetched once after the window
    if answers:
        its = torch.stack([a[3] for a in answers], 1).cpu()  # (S, rounds, 1, L)
        valid = torch.stack([a[4] for a in answers], 1).cpu()
        for c, chain in enumerate(chains):
            pairs = [(int((offsets[c] + k - 1) % N), int((offsets[c] + k) % N)) for k, *_ in answers]
            chain.add(pairs, np.stack([a[1][c] for a in answers]), np.stack([a[2][c] for a in answers]),
                      its[c], valid[c])
            chain.pose = poses[c]
    return {"t_start": t_start, "frames_done": len(latencies), "chains": chains, "calls": calls,
            "attempted": len(latencies), "missing": 0, "latencies": latencies}
