"""The frame-to-frame visual odometry loop of phovo-vo's frame mode
(torch port of phovo_tpu/models/sequence.py): each consecutive pair
through a backend's object API, the global pose integrated as pose <-
pose @ Rt^-1 (the reference VO app's loop), a warm start from the pair
before where asked (the reference starts every pair from zero), and
checkpoints (frame index, global pose, last state as JSON) to resume
from. The backend runs where its object API runs (the card by default).
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

from phovo_tpu_torch.datasets.tum import RGBDFrame
from phovo_tpu_torch.models.base import PhotoconsistencyOdometryBase
from phovo_tpu_torch.ops import se3


@dataclasses.dataclass
class FrameResult:
    timestamp: float
    global_pose: np.ndarray  # (4, 4)
    relative_state: np.ndarray  # (6,)
    align_seconds: float
    iterations: np.ndarray  # per-level


@dataclasses.dataclass
class Checkpoint:
    frame_index: int
    global_pose: np.ndarray
    last_state: np.ndarray

    def save(self, path: str | Path) -> None:
        Path(path).write_text(
            json.dumps(
                {
                    "frame_index": self.frame_index,
                    "global_pose": self.global_pose.tolist(),
                    "last_state": self.last_state.tolist(),
                }
            )
        )

    @staticmethod
    def load(path: str | Path) -> "Checkpoint":
        d = json.loads(Path(path).read_text())
        return Checkpoint(
            int(d["frame_index"]),
            np.asarray(d["global_pose"]),
            np.asarray(d["last_state"]),
        )


class VisualOdometryPipeline:
    """Drives a backend's object API over a frame stream, integrating the
    global pose; every checkpoint_every frames it saves a Checkpoint."""

    def __init__(
        self,
        odometry: PhotoconsistencyOdometryBase,
        warm_start: bool = False,
        checkpoint_path: str | Path | None = None,
        checkpoint_every: int = 50,
    ):
        self.odometry = odometry
        self.warm_start = warm_start
        self.checkpoint_path = Path(checkpoint_path) if checkpoint_path else None
        self.checkpoint_every = checkpoint_every
        self.global_pose = np.eye(4)
        self.frame_index = 0
        self._last_state = np.zeros(6, dtype=np.float32)

    def resume(self, ckpt: Checkpoint) -> None:
        self.global_pose = np.asarray(ckpt.global_pose)
        self.frame_index = ckpt.frame_index
        self._last_state = np.asarray(ckpt.last_state, dtype=np.float32)

    def run(self, frames: Iterable[RGBDFrame]) -> Iterator[FrameResult]:
        it = iter(frames)
        # skip frames already processed when resuming
        for _ in range(self.frame_index):
            next(it, None)
        try:
            prev = next(it)
        except StopIteration:
            return
        for cur in it:
            self.odometry.set_source_frame(prev.intensity, prev.depth)
            self.odometry.set_target_frame(cur.intensity, cur.depth)
            init = self._last_state if self.warm_start else np.zeros(6, np.float32)
            self.odometry.set_initial_state_vector(init)

            t0 = time.perf_counter()
            result = self.odometry.optimize()
            state = result.state.cpu().numpy()  # waits for the device
            dt = time.perf_counter() - t0

            Rt = se3.pose_matrix_np(state)
            self.global_pose = self.global_pose @ np.linalg.inv(Rt)
            self._last_state = state
            self.frame_index += 1

            if (
                self.checkpoint_path is not None
                and self.frame_index % self.checkpoint_every == 0
            ):
                Checkpoint(self.frame_index, self.global_pose, state).save(
                    self.checkpoint_path
                )

            yield FrameResult(
                timestamp=cur.timestamp,
                global_pose=self.global_pose.copy(),
                relative_state=state,
                align_seconds=dt,
                iterations=result.iterations.cpu().numpy(),
            )
            prev = cur
