"""The port's difference images and timers (utils/viz.py,
utils/profiling.py) against phovo_tpu's, on the CPU: alignment_diff
equal to phovo_tpu's; save_image's PNG (zlib and struct, no cv2) decoding
to the pixels of the PNG phovo_tpu writes with cv2, for uint8 and float
input; side_by_side equal; the Stopwatch; a profiler trace written and
summarized.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from phovo_tpu.ops.camera import Intrinsics as JIntrinsics
from phovo_tpu.utils import viz as jviz
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.utils import profiling, viz
from phovo_tpu_torch.utils.synthetic import make_pair

INTR = Intrinsics(80.0, 80.0, 39.5, 29.5)
JINTR = JIntrinsics(*(np.float32(v) for v in INTR))


@pytest.fixture(scope="module")
def pair():
    return make_pair(INTR, (60, 80), np.array([0.01, -0.02, 0.06, 0.01, -0.02, 0.015], np.float32))


@pytest.mark.parametrize("at", ["truth", "zero"])
def test_alignment_diff_matches_jax(pair, at):
    I0, D0, I1, _, gt = pair
    state = gt if at == "truth" else np.zeros(6, np.float32)
    diff = viz.alignment_diff(I0, D0, I1, state, INTR, device="cpu")
    assert diff.dtype == np.float32 and diff.shape == I0.shape
    np.testing.assert_array_equal(diff, jviz.alignment_diff(I0, D0, I1, state, JINTR))
    if at == "truth":  # the reference's oracle: near black where the warp lands
        assert np.median(diff[diff > 0]) < 0.1 or np.median(diff) < 0.02


def _images(pair):
    I0, D0, I1, _, gt = pair
    diff = viz.alignment_diff(I0, D0, I1, gt, INTR, device="cpu")
    return {
        "u8": (np.round(I0 * 255).astype(np.uint8), None),
        "unit": (diff, True),
        "u8-range float": (diff * 255.0, False),
        "guess": (I0, None),
        "out of range": (np.linspace(-50, 300, 60 * 80, dtype=np.float32).reshape(60, 80), False),
    }


@pytest.mark.parametrize("kind", ["u8", "unit", "u8-range float", "guess", "out of range"])
def test_save_image_decodes_to_phovo_tpus_pixels(pair, tmp_path, kind):
    img, unit_range = _images(pair)[kind]
    viz.save_image(tmp_path / "port.png", img, unit_range=unit_range)
    jviz.save_image(tmp_path / "jax.png", img, unit_range=unit_range)
    got = cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED)
    ref = cv2.imread(str(tmp_path / "jax.png"), cv2.IMREAD_UNCHANGED)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, ref)
    # the file is a plain PNG: signature, IHDR 8-bit grey, one zlib stream
    data = (tmp_path / "port.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h, depth, colour = struct.unpack(">IIBB", data[16:26])
    assert (h, w, depth, colour) == (*img.shape, 8, 0)
    n = struct.unpack(">I", data[33:37])[0]
    rows = np.frombuffer(zlib.decompress(data[41:41 + n]), np.uint8).reshape(h, w + 1)
    assert (rows[:, 0] == 0).all() and np.array_equal(rows[:, 1:], got)


def test_save_image_refuses_colour(tmp_path):
    with pytest.raises(ValueError, match="grayscale"):
        viz.save_image(tmp_path / "c.png", np.zeros((4, 4, 3), np.uint8))


def test_side_by_side_matches_jax(pair):
    I0, _, I1, _, _ = pair
    parts = (I0, I1[:40], np.ones((60, 10), np.float32))
    got = viz.side_by_side(*parts)
    np.testing.assert_array_equal(got, jviz.side_by_side(*parts))
    assert got.shape == (60, 80 + 4 + 80 + 4 + 10) and got.dtype == np.float32
    np.testing.assert_array_equal(viz.side_by_side(I0, I1, pad=2), jviz.side_by_side(I0, I1, pad=2))


def test_stopwatch_and_timer():
    sw = profiling.Stopwatch()
    sw.start()
    dt = sw.stop(torch.zeros(3), (torch.ones(2), {"a": torch.zeros(1)}))
    assert dt >= 0 and sw.count == 1 and sw.mean == sw.total == dt


def test_trace_writes_a_chrome_trace_and_summarizes_it(tmp_path):
    with profiling.trace(tmp_path / "prof") as window:
        x = torch.randn(64, 64)
        (x @ x).sum()
    assert window.path == tmp_path / "prof" / "trace.json" and window.path.is_file()
    summary = profiling.trace_summary(window)
    assert set(summary) == {"kernel_launches", "device_busy_ms", "wall_ms"}
    # on the CPU nothing runs on a card
    assert summary["kernel_launches"] == 0 and summary["device_busy_ms"] == 0.0 and summary["wall_ms"] > 0


def test_trace_summary_merges_overlapping_device_spans(tmp_path):
    """Device-busy time is the union of the kernel, copy and set spans."""
    import json

    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"cat": "kernel", "ts": 0, "dur": 10}, {"cat": "kernel", "ts": 5, "dur": 10},
        {"cat": "gpu_memcpy", "ts": 30, "dur": 5}, {"cat": "cpu_op", "ts": 0, "dur": 100},
    ]}))
    summary = profiling.trace_summary(profiling.TraceWindow(path=path, wall_ms=0.2))
    assert summary == {"kernel_launches": 2, "device_busy_ms": 0.02, "wall_ms": 0.2}


def test_alignment_diff_runs_on_the_card_by_default(pair, monkeypatch):
    """Like the object APIs, the warp runs on the CUDA card unless the
    caller names another device; where torch finds none, that raises."""
    import inspect

    assert inspect.signature(viz.alignment_diff).parameters["device"].default == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    I0, D0, I1, _, gt = pair
    with pytest.raises((RuntimeError, AssertionError)):
        viz.alignment_diff(I0, D0, I1, gt, INTR)
