"""Keyframe tracking with loop closures: phovo_tpu_torch's
KeyframeVisualOdometry (run, run_chunked level-major and serial, the ceres
backend, the batched closures, finalize and the incremental solve) against
phovo_tpu's on the CPU, on tests/test_keyframe.py's sequence (9 frames of
the synthetic plane at 96x128, out along +x and back, rendered once with
numpy and handed to both packages) and its CFG.

Held: the keyframes' frame indices, the odometry edges and the
loop-closure pairs equal; tracked poses within 1e-5 where both packages
track frame by frame from the same inits (run, run_chunked 'off': the
per-pair level's plain version against phovo_tpu's XLA route, 2.5e-6
apart here) and within 1e-3 where the port tracks a chunk level-major
from anchored inits (tests/test_keyframe.py:442's bound for that route);
the ceres backend's per-frame run within 2e-4 (the trust-region level's
bound against phovo_tpu, tests/test_torch_trust_region.py); the closures'
relative poses within the same bound as the poses and mean residuals
within 1e-5; the finalized poses within 1e-5 of phovo_tpu's finalize of
the same run. finalize with the photometric bundle adjustment is held to
phovo_tpu's bounds on the port alone: the trajectory within 2 cm, the
landmark map on the plane within 2 cm, perturbed keyframes pulled back
(tests/test_torch_photometric_ba.py holds the refinement to phovo_tpu's on
shared keyframes).
On the CPU the level kernels' plain versions run and nothing launches.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from phovo_tpu.datasets.tum import RGBDFrame as JFrame
from phovo_tpu.models.analytic import PhotoconsistencyOdometryAnalytic as JAnalytic
from phovo_tpu.models.autodiff import PhotoconsistencyOdometryAutodiff as JAutodiff
from phovo_tpu.models.keyframe import KeyframeVisualOdometry as JKeyframeVO
from phovo_tpu.utils.config import PhovoConfig as JConfig
from phovo_tpu_torch.datasets.tum import RGBDFrame
from phovo_tpu_torch.models import analytic as tan
from phovo_tpu_torch.models import keyframe as tkf
from phovo_tpu_torch.models.autodiff import PhotoconsistencyOdometryAutodiff
from phovo_tpu_torch.models.ic import PhotoconsistencyOdometryIC
from phovo_tpu_torch.ops import fused_batch as FB
from phovo_tpu_torch.ops import se3
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.utils.config import PhovoConfig
from phovo_tpu_torch.utils.synthetic import render_plane

torch.set_num_threads(1)

INTR = Intrinsics(128.0, 128.0, 63.5, 47.5)
K = np.asarray([[INTR.fx, 0, INTR.cx], [0, INTR.fy, INTR.cy], [0, 0, 1]], np.float32)
SHAPE = (96, 128)
DEPTH_SCALE = 1.0 / 5000.0
CFG = dict(
    num_levels=2, blur_filter_sizes=(0, 0), gradient_scales=(0.0625, 0.0625),
    max_iterations=(10, 12), lambda_steps=(1.0, 1.0), min_gradient_norms=(1e-10, 1e-10),
    sampling="bilinear",
)
# tests/test_keyframe.py's ceres schedule: the stopping tests off
CERES = dict(
    CFG, function_tolerances=(1e-9,) * 2, gradient_tolerances=(1e-12,) * 2,
    parameter_tolerances=(1e-10,) * 2, initial_trust_region_radii=(1e4,) * 2,
    max_trust_region_radii=(1e8,) * 2, min_trust_region_radii=(1e-32,) * 2,
    min_relative_decreases=(1e-3,) * 2,
)
KVO = dict(kf_translation=0.08, kf_rotation=0.1, loop_radius=0.15, loop_min_gap=2, loop_weight=50.0)
SERIAL_ATOL = 1e-5
LEVELMAJOR_ATOL = 1e-3
# the ceres backend frame by frame: tests/test_torch_trust_region.py's bound
# for the trust-region level against phovo_tpu (1.1e-5 apart here): near
# convergence its accept/reject steps are float32 noise
TR_ATOL = 2e-4


def _states():
    """tests/test_keyframe.py's out-and-back camera states."""
    n, reach = 9, 0.24
    xs = np.concatenate([np.linspace(0, reach, n // 2 + 1), np.linspace(reach, 0.02, n - n // 2 - 1)])
    return [np.array([x, 0.01 * np.sin(k), 0.0, 0.05 * x, 0.0, 0.0]) for k, x in enumerate(xs)]


@pytest.fixture(scope="module")
def frames():
    """(uint8 intensity, float32 depth) along _states."""
    out = []
    for st in _states():
        I, D = render_plane(INTR, SHAPE, se3.pose_matrix_np(st))
        out.append(((I * 255).astype(np.uint8), D))
    return out


def _jax_kvo(cfg=CFG, ceres=False, **kw):
    vo = (JAutodiff if ceres else JAnalytic)(JConfig(**cfg))
    vo.set_intrinsic_matrix(K)
    return JKeyframeVO(vo, **KVO, **kw)


def _port_kvo(cfg=CFG, ceres=False, **kw):
    cls = PhotoconsistencyOdometryAutodiff if ceres else tan.PhotoconsistencyOdometryAnalytic
    vo = cls(PhovoConfig(**cfg), device="cpu")
    vo.set_intrinsic_matrix(K)
    return tkf.KeyframeVisualOdometry(vo, **KVO, **kw)


def _jframes(frames):
    return [JFrame(float(k), float(k), I, D) for k, (I, D) in enumerate(frames)]


def _tframes(frames):
    return [RGBDFrame(float(k), float(k), I, D) for k, (I, D) in enumerate(frames)]


@pytest.fixture(scope="module")
def jax_runs(frames):
    """phovo_tpu's run() of the analytic and the ceres backend: the
    tracker, and its tracked poses before finalize."""
    out = {}
    for name, kvo in (("analytic", _jax_kvo()), ("ceres", _jax_kvo(CERES, ceres=True))):
        tracked = list(kvo.run(_jframes(frames)))
        out[name] = (kvo, [tf.pose.copy() for tf in tracked])
    return out


def _assert_same_track(port, tracked, ref, ref_poses, atol):
    assert [k.frame_index for k in port.keyframes] == [k.frame_index for k in ref.keyframes]
    assert [(i, j) for i, j, _ in port.odometry_edges] == [(i, j) for i, j, _ in ref.odometry_edges]
    assert [(c.from_kf, c.to_kf) for c in port.loop_closures] == [(c.from_kf, c.to_kf) for c in ref.loop_closures]
    assert len(tracked) == len(ref_poses)
    for tf, pose in zip(tracked, ref_poses):
        np.testing.assert_allclose(tf.pose, pose, rtol=0, atol=atol)
    for a, b in zip(port.loop_closures, ref.loop_closures):
        np.testing.assert_allclose(a.relative, b.relative, rtol=0, atol=atol)
        assert abs(a.mean_residual - b.mean_residual) < 1e-5


def test_run_matches_jax(frames, jax_runs):
    ref, ref_poses = jax_runs["analytic"]
    before = FB.LAUNCHES
    kvo = _port_kvo()
    tracked = list(kvo.run(_tframes(frames)))
    _assert_same_track(kvo, tracked, ref, ref_poses, SERIAL_ATOL)
    assert len(kvo.keyframes) >= 3 and len(kvo.loop_closures) >= 1
    assert FB.LAUNCHES == before
    assert kvo.keyframes[0].dev_intensity.device.type == "cpu"


@pytest.mark.parametrize("chunk,levelmajor", [(3, "auto"), (16, "auto"), (4, "interpret"), (3, "off"), (16, "off")])
def test_run_chunked_matches_jax_run(frames, jax_runs, chunk, levelmajor):
    """Chunks of 3, 4 and 16 frames, level-major ('auto', and 'interpret'
    taken as 'auto') and the serial scan ('off'), against phovo_tpu's
    per-frame run."""
    ref, ref_poses = jax_runs["analytic"]
    kvo = _port_kvo()
    with mock.patch.object(tkf, "track_chunk_levelmajor", wraps=tkf.track_chunk_levelmajor) as lm:
        tracked = list(kvo.run_chunked(_tframes(frames), chunk=chunk, levelmajor=levelmajor))
    assert (lm.call_count > 0) == (levelmajor != "off")
    _assert_same_track(kvo, tracked, ref, ref_poses, SERIAL_ATOL if levelmajor == "off" else LEVELMAJOR_ATOL)


@pytest.mark.parametrize("levelmajor", ["auto", "off"])
def test_run_chunked_storage_depth_matches_jax(frames, levelmajor):
    """uint16 depth counts converted on the device (depth_scale) against
    phovo_tpu's run on the same quantized depths in metres; promoted
    keyframes hold metric depth."""
    storage = [(I, np.clip(D.astype(np.float64) / DEPTH_SCALE + 0.5, 0, 65535).astype(np.uint16)) for I, D in frames]
    metric = [(I, D16.astype(np.float32) * np.float32(DEPTH_SCALE)) for I, D16 in storage]
    ref = _jax_kvo()
    ref_poses = [tf.pose.copy() for tf in ref.run(_jframes(metric))]
    kvo = _port_kvo()
    tracked = list(kvo.run_chunked(_tframes(storage), chunk=4, depth_scale=DEPTH_SCALE, levelmajor=levelmajor))
    _assert_same_track(kvo, tracked, ref, ref_poses, SERIAL_ATOL if levelmajor == "off" else LEVELMAJOR_ATOL)
    for kf in kvo.keyframes:
        assert kf.depth.dtype == np.float32 and float(kf.depth.max()) < 100.0


def test_ceres_run_and_run_chunked_match_jax(frames, jax_runs):
    """The trust-region backend: run() frame by frame, and run_chunked
    level-major through the shared-source trust-region level (the closures
    align one by one through the object API, cost 0.5 sum r^2); 'off'
    raises, as in phovo_tpu."""
    ref, ref_poses = jax_runs["ceres"]
    kvo = _port_kvo(CERES, ceres=True)
    _assert_same_track(kvo, list(kvo.run(_tframes(frames))), ref, ref_poses, TR_ATOL)
    kvo = _port_kvo(CERES, ceres=True)
    with mock.patch.object(tkf, "track_chunk_levelmajor_tr", wraps=tkf.track_chunk_levelmajor_tr) as lm:
        tracked = list(kvo.run_chunked(_tframes(frames), chunk=4))
    assert lm.call_count > 0
    _assert_same_track(kvo, tracked, ref, ref_poses, LEVELMAJOR_ATOL)
    with pytest.raises(RuntimeError, match="level-major"):
        list(_port_kvo(CERES, ceres=True).run_chunked(_tframes(frames), levelmajor="off"))


def test_batched_closures_match_serial(frames):
    """The analytic backend's closure candidates align in one batch
    (parallel/batch.py::align_batch), gated at the flush: the closures of
    the serial per-candidate path, relative poses within 1e-5."""
    serial = _port_kvo()
    serial._analytic_batch_context = lambda: None
    list(serial.run(_tframes(frames)))
    assert not serial._pending_closures
    kvo = _port_kvo()
    with mock.patch.object(tkf, "align_batch", wraps=tkf.align_batch) as batch:
        list(kvo.run(_tframes(frames)))
    assert batch.call_count >= 1 and not kvo._pending_closures
    assert len(serial.loop_closures) >= 1
    assert [(c.from_kf, c.to_kf) for c in kvo.loop_closures] == [(c.from_kf, c.to_kf) for c in serial.loop_closures]
    for a, b in zip(kvo.loop_closures, serial.loop_closures):
        np.testing.assert_allclose(a.relative, b.relative, rtol=0, atol=1e-5)
        assert abs(a.mean_residual - b.mean_residual) < 1e-5


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_finalize_matches_jax(frames, solver):
    ref = _jax_kvo()
    ref.pg_solver = solver
    list(ref.run(_jframes(frames)))
    ref_final = [tf.pose.copy() for tf in ref.finalize(iterations=8)]
    kvo = _port_kvo(pg_solver=solver)
    list(kvo.run(_tframes(frames)))
    final = kvo.finalize(iterations=8)
    assert set(kvo.finalize_timings) == {"pg_build", "pg_solve", "pose_graph", "photometric_ba"}
    for tf, pose in zip(final, ref_final):
        np.testing.assert_allclose(tf.pose, pose, rtol=0, atol=SERIAL_ATOL)


def test_incremental_solve_matches_jax(frames):
    """pg_incremental=2: the graph solved and the keyframes rebased every
    second promotion, as in phovo_tpu; then finalize."""
    ref = _jax_kvo(pg_incremental=2)
    list(ref.run(_jframes(frames)))
    ref_final = [tf.pose.copy() for tf in ref.finalize(iterations=8)]
    kvo = _port_kvo(pg_incremental=2)
    list(kvo.run(_tframes(frames)))
    assert kvo.incremental_solves == ref.incremental_solves >= 1
    assert len(kvo.incremental_breakdown) == kvo.incremental_solves
    for tf, pose in zip(kvo.finalize(iterations=8), ref_final):
        np.testing.assert_allclose(tf.pose, pose, rtol=0, atol=SERIAL_ATOL)


@pytest.mark.parametrize("levelmajor", ["auto", "interpret"])
def test_tdist_chunks_take_the_serial_scan(frames, levelmajor):
    """No levelmajor value routes a Student-t chunk level-major: phovo_tpu's
    gate (analytic.py:768) sends it to the serial scan, and so does the
    port's, 'interpret' included."""
    cfg = dict(CFG, robust_loss="tdist", robust_delta=0.1)
    assert not tan.track_levelmajor_eligible(PhovoConfig(**cfg))
    kvo = _port_kvo(cfg)
    with mock.patch.object(tkf, "track_chunk_levelmajor", side_effect=AssertionError("level-major")), \
            mock.patch.object(tkf, "track_sequence_chunk", wraps=tkf.track_sequence_chunk) as scan:
        tracked = list(kvo.run_chunked(_tframes(frames), chunk=4, levelmajor=levelmajor))
    assert scan.call_count > 0 and len(tracked) == len(frames) - 1


def test_band_fallback_never_fires_and_cpu_launches_nothing(frames):
    """band_fallback is accepted and stored; the GPU kernels sample the
    whole target (band_masked 0), so it never engages."""
    before = (FB.LAUNCHES, FB.TR_LAUNCHES, FB.LIN_LAUNCHES)
    kvo = _port_kvo(band_fallback=0.5)
    with mock.patch.object(tkf, "to_host", wraps=tkf.to_host) as host:
        list(kvo.run_chunked(_tframes(frames), chunk=4))
    assert kvo.band_fallback == 0.5 and kvo.band_fallbacks == 0
    assert all(float(call.args[0].band_masked.abs().sum()) == 0.0 for call in host.call_args_list)
    assert (FB.LAUNCHES, FB.TR_LAUNCHES, FB.LIN_LAUNCHES) == before


def test_finalize_with_photometric_ba(frames):
    """finalize(ba_iterations > 0) refines the keyframes with windowed
    photometric BA and keeps the (already accurate) trajectory accurate
    (tests/test_keyframe.py's bound: mean position error below 2 cm)."""
    kvo = _port_kvo()
    list(kvo.run(_tframes(frames)))
    tracked = kvo.finalize(iterations=8, ba_iterations=4, ba_window=4, ba_grid=6)
    gts = [np.linalg.inv(se3.pose_matrix_np(st)) for st in _states()]
    err = np.mean([np.linalg.norm(tf.pose[:3, 3] - gt[:3, 3]) for tf, gt in zip(tracked, gts[1:])])
    assert err < 0.02, err
    assert all(np.isfinite(tf.pose).all() for tf in tracked)
    assert kvo.finalize_timings["photometric_ba"] > 0.0 and kvo.map_points is not None


def test_photometric_ba_fixes_perturbed_keyframes(frames):
    """Keyframe poses corrupted after tracking are pulled back toward their
    tracked values from the stored images alone (tests/test_keyframe.py's
    bound: the mean error at least halved)."""
    kvo = _port_kvo()
    list(kvo.run(_tframes(frames)))
    assert len(kvo.keyframes) >= 3
    rng = np.random.default_rng(0)
    ref = {k.index: k.pose.copy() for k in kvo.keyframes}
    for k in kvo.keyframes[1:]:
        k.pose = k.pose @ se3.pose_matrix_np(rng.normal(0.0, 0.008, 6))

    def err():
        return np.mean([np.linalg.norm(k.pose[:3, 3] - ref[k.index][:3, 3]) for k in kvo.keyframes])

    before = err()
    kvo._refine_photometric(None, iterations=6, window=4, grid=6, damping=1e-4)
    assert err() < before / 2, (before, err())


@pytest.mark.parametrize("scope", ["window", "global"])
def test_finalize_exports_the_landmark_map(frames, tmp_path, scope):
    """finalize(ba_iterations > 0) fills map_points and map_intensity; the
    landmarks lie on the rendered plane n.p = d (median distance below 2 cm,
    tests/test_keyframe.py's oracle), and save_ply writes a valid ASCII PLY
    of them."""
    from phovo_tpu_torch.utils.viz import save_ply

    kvo = _port_kvo()
    list(kvo.run(_tframes(frames)))
    kvo.finalize(ba_iterations=2, ba_scope=scope, ba_covis=3)
    assert kvo.map_points is not None and len(kvo.map_points) > 20
    assert len(kvo.map_intensity) == len(kvo.map_points)
    n = np.array([0.06, -0.04, 1.0])
    d = np.abs(kvo.map_points @ n - 2.0) / np.linalg.norm(n)
    assert float(np.median(d)) < 0.02, float(np.median(d))
    ply = tmp_path / "map.ply"
    save_ply(ply, kvo.map_points, kvo.map_intensity)
    txt = ply.read_text().splitlines()
    assert txt[0] == "ply" and "end_header" in txt
    n_hdr = int([ln for ln in txt if ln.startswith("element vertex")][0].split()[-1])
    body = txt[txt.index("end_header") + 1:]
    assert n_hdr == len(kvo.map_points) == len(body) and len(body[0].split()) == 6
    np.testing.assert_allclose(np.array([[float(v) for v in ln.split()[:3]] for ln in body]), kvo.map_points,
                               atol=1e-6)


def test_unported_and_invalid_calls_raise(frames):
    from phovo_tpu_torch.parallel.mesh import make_mesh

    # finalize over a one-rank mesh (no process group): the unsharded poses
    runs = []
    for mesh in (make_mesh(1, devices=["cpu"]), None):
        kvo = _port_kvo()
        list(kvo.run(_tframes(frames[:3])))
        runs.append([tf.pose.copy() for tf in kvo.finalize(mesh=mesh)])
    assert all(np.array_equal(a, b) for a, b in zip(*runs))
    with pytest.raises(ValueError, match="levelmajor"):
        list(_port_kvo().run_chunked(_tframes(frames), levelmajor="on"))
    vo = PhotoconsistencyOdometryIC(PhovoConfig(**CFG), device="cpu")
    vo.set_intrinsic_matrix(K)
    with pytest.raises(ValueError, match="analytic or the ceres"):
        list(tkf.KeyframeVisualOdometry(vo).run_chunked(_tframes(frames)))
    # a single keyframe: finalize leaves the poses and builds a null graph
    one = _port_kvo()
    list(one.run(_tframes(frames[:2])))
    assert len(one.keyframes) == 1 and one.build_pose_graph().weights.tolist() == [0.0]
    assert np.array_equal(one.finalize()[0].pose, one.tracked[0].pose)
    # to_host keeps every field's dtype and shape
    res = tan.align_analytic(*(torch.from_numpy(x) for x in (*frames[0], *frames[1])), INTR, torch.zeros(6),
                             PhovoConfig(**CFG))
    host = tkf.to_host(res)
    for a, b in zip(host, res):
        assert a.dtype == b.dtype and torch.equal(a, b)
