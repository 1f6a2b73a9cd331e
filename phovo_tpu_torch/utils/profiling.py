"""Per-frame metrics as JSON lines (torch port of the MetricsLogger of
phovo_tpu/utils/profiling.py; phovo-vo --metrics). The timers and the
profiler trace of that module wait for ROADMAP.md queue A, item 12.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch


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
