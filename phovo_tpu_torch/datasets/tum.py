"""TUM RGB-D sequences (torch port of phovo_tpu/datasets/tum.py): the
index files, the timestamp or lockstep pairing of the rgb and depth
streams, the frame record, a PNG reader and a background prefetch.

The PNG reader decodes with cv2, imported inside the two loaders: the
machine with the card has no cv2, and reads a sequence converted once to
the raw format (datasets/raw.py) or through the libpng loader
(datasets/native_loader.py) instead.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from pathlib import Path
from typing import Iterable, Iterator, NamedTuple

import numpy as np

# TUM depth PNGs store depth * 5000 (the reference's VO app); the frame
# alignment app reads depth at 1/1000.
TUM_DEPTH_SCALE = 1.0 / 5000.0


class IndexEntry(NamedTuple):
    timestamp: float
    path: Path


@dataclasses.dataclass
class RGBDFrame:
    timestamp: float  # intensity timestamp (the one the reference writes)
    depth_timestamp: float
    intensity: np.ndarray  # (H, W) uint8 grayscale
    depth: np.ndarray  # (H, W) float32 metres (0 = invalid), or uint16 counts


def read_index(index_file: str | Path) -> list[IndexEntry]:
    """A TUM index file: lines of 'timestamp filename', '#' comments and
    lines of one field skipped, paths relative to the file's directory."""
    index_file = Path(index_file)
    if not index_file.is_file():
        raise FileNotFoundError(f"cannot open record file {index_file}")
    base = index_file.parent
    entries = []
    for line in index_file.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 2:
            continue
        entries.append(IndexEntry(float(parts[0]), base / parts[1]))
    return entries


def associate(
    a: list[IndexEntry], b: list[IndexEntry], max_dt: float = 0.02
) -> list[tuple[IndexEntry, IndexEntry]]:
    """Greedy nearest-timestamp association of two streams (TUM
    associate.py; utils/trajectory.py::associate_timestamps)."""
    from phovo_tpu_torch.utils.trajectory import associate_timestamps

    ia, ib = associate_timestamps(
        np.asarray([e.timestamp for e in a], np.float64),
        np.asarray([e.timestamp for e in b], np.float64),
        max_dt,
    )
    return [(a[i], b[j]) for i, j in zip(ia, ib)]


def _load_intensity(path: Path) -> np.ndarray:
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)  # the reference's flag 0
    if img is None:
        raise IOError(f"cannot read image {path}")
    return img


def _load_depth(path: Path, depth_scale: float) -> np.ndarray:
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)  # the reference's flag -1
    if img is None:
        raise IOError(f"cannot read image {path}")
    return img.astype(np.float32) * depth_scale


class TUMSequence:
    """Iterable of RGBDFrame over a TUM sequence directory: uint8
    intensity, float32 metric depth.

    pairing='lockstep' pairs the index files line by line and stops at the
    end of either (the reference's pairing); pairing='associate' matches
    nearest timestamps within max_dt."""

    def __init__(
        self,
        root: str | Path,
        rgb_index: str = "rgb.txt",
        depth_index: str = "depth.txt",
        depth_scale: float = TUM_DEPTH_SCALE,
        pairing: str = "associate",
        max_dt: float = 0.02,
    ):
        root = Path(root)
        self.rgb_entries = read_index(root / rgb_index)
        self.depth_entries = read_index(root / depth_index)
        self.depth_scale = depth_scale
        if pairing == "lockstep":
            n = min(len(self.rgb_entries), len(self.depth_entries))
            self.pairs = list(zip(self.rgb_entries[:n], self.depth_entries[:n]))
        elif pairing == "associate":
            self.pairs = associate(self.rgb_entries, self.depth_entries, max_dt)
        else:
            raise ValueError(f"unknown pairing {pairing!r}")

    def __len__(self) -> int:
        return len(self.pairs)

    def __iter__(self) -> Iterator[RGBDFrame]:
        for rgb, dep in self.pairs:
            yield RGBDFrame(
                timestamp=rgb.timestamp,
                depth_timestamp=dep.timestamp,
                intensity=_load_intensity(rgb.path),
                depth=_load_depth(dep.path, self.depth_scale),
            )


def prefetch(frames: Iterable[RGBDFrame], depth: int = 2) -> Iterator[RGBDFrame]:
    """Decode frames k+1..k+depth in a background thread while the caller
    aligns frame k; a decode error is raised to the caller in order."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list[BaseException] = []

    def worker():
        try:
            for f in frames:
                q.put(f)
        except BaseException as e:  # handed to the consumer, which re-raises it
            err.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item
