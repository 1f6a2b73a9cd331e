"""tools/parity_harness_torch.py (the port against the reference-exact
oracle) against tools/parity_harness.py (phovo_tpu against the same
oracle), on the CPU: the cluttered scene, 4 frames at 60x80, two presets
(the analytic one runs the analytic and bi-objective backends, the ceres
one the trust-region backend), the same frames into both harnesses.

The oracle columns are the same code on the same frames, so equal
exactly. The framework columns are two implementations: the port's ATE
against ground truth and against the oracle within 1e-4 m of phovo_tpu's.
Reading on the CPU: the fw-vs-gt ATEs differ by 5e-9 m (analytic), 1e-9
(bi-objective) and 3.3e-6 (ceres).
The numpy stand-in for OpenCV that the oracle gets on a machine without
cv2 agrees with cv2 to 1e-12 on float64 images.
"""

import numpy as np
import pytest
import torch

from phovo_tpu.ops import se3 as jse3
from phovo_tpu.utils.config import load_builtin as jax_load_builtin
from tools import parity_harness as jharness
from tools import parity_harness_torch as harness
from tools import reference_oracle

PRESETS = ["config_4_level_optimization_analytic", "config_4_level_optimization_ceres"]
ATE_ATOL = 1e-4


@pytest.fixture(scope="module")
def rows_and_frames():
    I, D, gt_poses, K = harness.scene_frames("cluttered", (60, 80), 4)
    rows = harness.run_harness(I, D, gt_poses, K, PRESETS, torch.device("cpu"), out=lambda s: None)
    return rows, (I, D, gt_poses, K)


def test_plan_is_phovo_tpus():
    assert harness.preset_plan(harness.ALL_PRESETS) == jharness.preset_plan(jharness.ALL_PRESETS)
    assert harness.ALL_PRESETS == jharness.ALL_PRESETS


@pytest.mark.parametrize("k", range(3))
def test_rows_match_the_jax_harness(rows_and_frames, k):
    rows, (I, D, gt_poses, K) = rows_and_frames
    row = rows[k]
    preset, backend = jharness.preset_plan(PRESETS)[k]
    assert (row["preset"], row["backend"]) == (preset, backend)
    cfg = jax_load_builtin(preset)
    I_u8 = [(img * 255).astype(np.uint8) for img in I]
    o_poses, _ = jharness.run_vo(jharness._oracle_backend(backend, cfg), I_u8, [d.astype(np.float64) for d in D], K,
                                 reference_oracle.pose_matrix)
    f_poses, _ = jharness.run_vo(jharness._framework_backend(backend, cfg), I_u8, D, K,
                                 lambda s: jse3.pose_matrix(s.astype(np.float64)))
    assert row["ate_oracle_vs_gt"] == jharness.ate_rmse(o_poses, gt_poses)
    ref_fw_gt = jharness.ate_rmse(f_poses, gt_poses)
    print(f"{preset} {backend}: fw vs gt port {row['ate_fw_vs_gt']:.9f} phovo_tpu {ref_fw_gt:.9f}")
    assert abs(row["ate_fw_vs_gt"] - ref_fw_gt) <= ATE_ATOL
    assert abs(row["ate_fw_vs_oracle"] - jharness.ate_rmse(f_poses, o_poses)) <= ATE_ATOL


def test_tables_have_the_jax_harness_format(rows_and_frames, tmp_path):
    import json

    rows, _ = rows_and_frames
    harness.write_tables(rows, {"frames": 4, "shape": [60, 80], "scene": "cluttered", "motion_scale": 1.0,
                                "device": "cpu"}, tmp_path / "p.md", tmp_path / "p.json")
    md = (tmp_path / "p.md").read_text().splitlines()
    assert md[0] == ("| preset | backend | ATE fw vs oracle (m) | ATE oracle vs GT | ATE fw vs GT | max state delta |")
    assert len(md) == 2 + len(rows)
    data = json.loads((tmp_path / "p.json").read_text())
    assert data["rows"] == rows and data["scene"] == "cluttered"
    assert set(rows[0]) == {"preset", "backend", "ate_fw_vs_oracle", "ate_oracle_vs_gt", "ate_fw_vs_gt",
                            "max_state_delta", "oracle_seconds", "framework_seconds"}


@pytest.mark.parametrize("fn", ["resize", "GaussianBlur", "Scharr"])
def test_numpy_stand_in_matches_opencv(fn):
    import cv2

    img = np.random.default_rng(0).random((60, 80))
    np_cv = harness.NumpyCV2
    if fn == "resize":
        pairs = [(cv2.resize(img, (0, 0), fx=f, fy=f), np_cv.resize(img, (0, 0), fx=f, fy=f))
                 for f in (0.5, 0.25, 0.125, 0.0625)]
    elif fn == "GaussianBlur":
        pairs = [(cv2.GaussianBlur(img, (k, k), 3), np_cv.GaussianBlur(img, (k, k), 3)) for k in (3, 5)]
    else:
        pairs = [(cv2.Scharr(img, cv2.CV_64F, dx, 1 - dx, scale=s, delta=0.0),
                  np_cv.Scharr(img, np_cv.CV_64F, dx, 1 - dx, scale=s, delta=0.0)) for dx in (0, 1) for s in (1, 0.0625)]
    for ref, got in pairs:
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
