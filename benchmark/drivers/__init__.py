"""How a cell drives the program: the traffic mix's "driver" names a
module of this package, benchmark/drivers/<driver>.py, whose drive()
runs the window, and the configuration file's "program" the entries it
calls (Program, here with what the drivers share).

  * replay: the sequence in chunks through the chunked entry,
    closed loop, as `phovo-vo --chunk N` runs it: each chunk goes to the
    card in storage dtype, the carry frame stays there, and the host
    integrates chunk k's poses in float64 after chunk k + 1 is dispatched;
    after the last frame the sequence starts again with a new carry;
  * live: one camera, open loop at the mix's frame rate, in frame mode:
    each pair through the object API (set_source_frame,
    set_target_frame, set_initial_state_vector, optimize), as phovo-vo's
    frame mode and models/sequence.VisualOdometryPipeline run it;
  * fleet: cameras in step, one new frame a camera a round through the
    serving round's entry, the frames copied from pinned grabber buffers.

A driver warms up the calls and shapes its window uses, then runs the
window and returns what the program answered: chains of pairs with the
state each started from (zero unless the driver says otherwise), their
states, iteration and valid counts and the poses the harness integrated,
the host times, and the calls (for the trace's work). A chain may carry
a back end's keyframe poses (Chain.keyframes), and a driver that runs on
to the end of a pass returns the window's true length as "window_s".
The program is imported by Program and nowhere else in the harness, by
the names the configuration file gives.
"""

from __future__ import annotations

import importlib
import re
import time

import numpy as np
import torch

from benchmark import work


def _resolve(dotted: str):
    """The object a dotted path names, module then attribute."""
    module, _, name = dotted.rpartition(".")
    return getattr(importlib.import_module(module), name)


class Program:
    """The system under test as a configuration file names it: under
    "program", its chunked entry and the options it takes, its object API,
    the call that builds or loads its kernels and the level kernels it
    launches (work model name -> the kernel's name in the trace); its
    PhovoConfig from "preset", and the camera."""

    def __init__(self, config: dict, device):
        from phovo_tpu_torch.ops.camera import Intrinsics
        from phovo_tpu_torch.utils.config import PhovoConfig

        cam, entries = config["camera"], config["program"]
        self.entries = entries
        self.cfg = PhovoConfig.from_dict(config["preset"])
        self.K = np.array([[cam["fx"], 0.0, cam["cx"]], [0.0, cam["fy"], cam["cy"]], [0.0, 0.0, 1.0]])
        self.intr = Intrinsics.from_matrix(self.K)
        self.depth_scale = 1.0 / float(cam["depth_counts_per_m"])
        self.device = device
        self.level_kernels = dict(entries["level_kernels"])
        self.sampling = self.cfg.sampling
        # every entry is looked up now: one the program lacks raises here
        self._library, self._chunk, self._api = (
            _resolve(entries[k]) for k in ("kernel_library", "chunk_entry", "object_api"))
        for model in self.level_kernels:
            work.kernel_model(model)

    def load_kernels(self) -> None:
        """Builds the kernels' library (nvcc, a checkout's first run) or
        loads the one built before."""
        self._library()

    def chunk_entry(self):
        """The chunked entry, called as phovo-vo --chunk calls it: (carry
        intensity, carry depth, intensities, depths, intrinsics, config) and
        the configuration's options."""
        fn, options = self._chunk, dict(self.entries["chunk_options"])

        def call(ci, cd, Ii, Dd, depth_scale):
            return fn(ci, cd, Ii, Dd, self.intr, self.cfg, warm_start=False, depth_scale=depth_scale, **options)

        return call

    def object_api(self):
        vo = self._api(self.cfg, device=self.device)
        vo.set_intrinsic_matrix(self.K)
        return vo


def to_device(array: np.ndarray, device) -> torch.Tensor:
    """A host array on the device in its own dtype (the CLIs' to_device)."""
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def inverse_poses(states) -> np.ndarray:
    """(..., 6) relative states -> (..., 4, 4) float64 inverses of their
    rigid transforms, R = Rz(yaw) Ry(pitch) Rx(roll)."""
    s = np.asarray(states, np.float64)
    x, y, z, yaw, pitch, roll = np.moveaxis(s, -1, 0)
    cy, sy, cp, sp, cr, sr = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch), np.cos(roll), np.sin(roll)
    R = np.stack([
        np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
        np.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
        np.stack([-sp, cp * sr, cp * cr], -1),
    ], -2)
    out = np.zeros(s.shape[:-1] + (4, 4))
    Rt = np.swapaxes(R, -1, -2)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -(Rt @ np.stack([x, y, z], -1)[..., None])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def integrate(pose: np.ndarray, states) -> tuple[np.ndarray, np.ndarray]:
    """pose <- pose @ Rt^-1 over a run of states ((..., n, 6), leading dims
    independent streams with poses (..., 4, 4)): the global pose after each
    state (..., n, 4, 4) and the last one."""
    inv = inverse_poses(states)
    out = np.empty_like(inv)
    for k in range(inv.shape[-3]):
        pose = pose @ inv[..., k, :, :]
        out[..., k, :, :] = pose
    return out, pose


class Chain:
    """The answers of one stream of pairs: answer k aligns frame pairs[k][0]
    to frame pairs[k][1] from the state inits[k]; `pose` is the last global
    pose the harness integrated. `keyframes`, where a driver sets it, is
    what a back end made of the chain's answers:
      * "frames": the keyframes' frame indices (K,);
      * "edges": (E, 3) rows (keyframe i, keyframe j, the index of the
        answer that measured the edge: a tracked pair or a loop closure);
      * "weights": (E,) the edges' weights;
      * "poses": (K, 4, 4) the keyframe poses the back end returned.
    The check hands the reference's answers to those edges and this graph
    to the configuration's "reference_backend" and compares the poses."""

    def __init__(self):
        self.pairs, self.states, self.poses, self.inits = [], [], [], []
        self.iterations, self.num_valid = [], []  # device tensors, fetched after the window
        self.pose = np.eye(4)
        self.keyframes = None

    def add(self, pairs, states, poses, res_iterations, res_num_valid, inits=None):
        """Answers to `pairs`, each started from its row of `inits` ((n, 6),
        zeros where None)."""
        self.pairs += pairs
        self.states.append(np.asarray(states, np.float32).reshape(-1, 6))
        self.poses.append(np.asarray(poses).reshape(-1, 4, 4))
        self.inits.append(np.zeros((len(pairs), 6), np.float32) if inits is None
                          else np.asarray(inits, np.float32).reshape(len(pairs), 6))
        self.iterations.append(res_iterations)
        self.num_valid.append(res_num_valid)

    def finish(self) -> dict:
        L = self.iterations[0].shape[-1] if self.iterations else 0

        def host(parts, dtype):
            if not parts:
                return np.zeros((0, L), dtype)
            return np.concatenate([p.detach().cpu().numpy().reshape(-1, L).astype(dtype) for p in parts])

        out = {
            "pairs": np.asarray(self.pairs, np.int64).reshape(-1, 2),
            "inits": np.concatenate(self.inits) if self.inits else np.zeros((0, 6), np.float32),
            "states": np.concatenate(self.states) if self.states else np.zeros((0, 6), np.float32),
            "poses": np.concatenate(self.poses) if self.poses else np.zeros((0, 4, 4)),
            "iterations": host(self.iterations, np.int64),
            "num_valid": host(self.num_valid, np.float32),
        }
        if self.keyframes is not None:
            kf = self.keyframes
            out["keyframes"] = {
                "frames": np.asarray(kf["frames"], np.int64).reshape(-1),
                "edges": np.asarray(kf["edges"], np.int64).reshape(-1, 3),
                "weights": np.asarray(kf["weights"], np.float64).reshape(-1),
                "poses": np.asarray(kf["poses"], np.float64).reshape(-1, 4, 4),
            }
        return out


def wait_until(t: float) -> None:
    """Spin until t: a frame is handled at its due time, and the time a
    sleeping process takes to be scheduled again is not counted as the
    program's."""
    while time.perf_counter() < t:
        pass


def tick(tracer, now, t_start):
    if tracer is not None and t_start is not None:
        tracer.tick(now, t_start)


def find(name: str):
    """The drive(prog, seq, mix, seconds, tracer, rng) of the driver a mix
    names."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"no driver named {name!r}")
    return importlib.import_module(f"benchmark.drivers.{name}").drive
