"""The port's CLIs (python -m phovo_tpu_torch.apps.<name>) on a synthetic
TUM fixture at 96x128 (7 frames, tests/test_tum_pipeline.py's pattern),
run in process through main(argv) with --device cpu:

  * phovo-vo against phovo_tpu's phovo-vo on the same fixture: frame mode,
    --chunk 4 analytic and ceres, keyframe mode without bundle adjustment;
    poses within 1e-4 (the chain tests' state tolerance: the two packages
    sum in other orders);
  * every backend's --chunk run equal, line for line, to the port's
    in-process align_sequence_chunk* chain over the same chunks;
  * checkpoint/resume, --metrics, the raw and libpng loaders, phovo-convert;
  * phovo-eval --json equal to phovo_tpu's; phovo-align within 1e-4 of
    phovo_tpu's; phovo-serve with two streams equal to each stream's own
    phovo-vo --chunk run;
  * phovo-vo --mode keyframe with each bundle-adjustment flag set
    (--ba-*, --export-map): the in-process finalize's lines, bit for bit;
    the default BA run and --ba-scope global --export-map within 1e-4 of
    phovo_tpu's;
  * phovo-align --save-diff and --save-diff-dir, and phovo-vo
    --save-diff-dir in frame mode, against phovo_tpu's images; the notes
    where the flag does nothing (--chunk, keyframe mode, no
    visualizeIterations, a trust-region backend);
  * the flags not ported yet raise NotImplementedError naming their
    ROADMAP item, and the default device raises without a card.
"""

import contextlib
import io
import json
import re
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from phovo_tpu_torch.apps import phovo_align, phovo_convert, phovo_eval, phovo_serve, phovo_vo
from phovo_tpu_torch.datasets import native_loader
from phovo_tpu_torch.ops import se3
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.utils.config import builtin_config_dir, load_config
from phovo_tpu_torch.utils.synthetic import render_plane
from phovo_tpu_torch.utils.trajectory import TrajectoryWriter, format_pose_line, read_trajectory

REPO = Path(__file__).resolve().parents[1]
INTR = Intrinsics(128.0, 128.0, 63.5, 47.5)
SPEC = "128,128,63.5,47.5"
SHAPE = (96, 128)
N_FRAMES = 7
CHUNK = 4
POSE_ATOL = 1e-4
# a schedule that converges on the fixture (bilinear, tight thresholds), and
# two shipped presets, read by each package's own reader
TIGHT = ("num_levels: 2\nblur_filter_sizes: [0, 0]\ngradient_scales: [0.0625, 0.0625]\nlambda_steps: [1, 1]\n"
         "max_iterations: [8, 8]\nmin_gradient_norms: [1e-9, 1e-9]\nsampling: bilinear\n")
ANALYTIC = builtin_config_dir() / "config_4_level_optimization_analytic.yml"
CERES = builtin_config_dir() / "config_4_level_optimization_ceres.yml"


def _camera_pose(k: int) -> np.ndarray:
    """World->camera pose of frame k: a slow forward turn."""
    return se3.pose_matrix_np(np.array([0.015 * k, -0.01 * k, 0.008 * k, 0.006 * k, -0.004 * k, 0.005 * k]))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The fixture's TUM directory (PNGs, index files with depth timestamps
    4 ms late, groundtruth.txt), its raw conversion, and the tight
    config."""
    root = tmp_path_factory.mktemp("cli")
    tum = root / "tum"
    (tum / "rgb").mkdir(parents=True)
    (tum / "depth").mkdir()
    rgb, dep, gt = ["# color images"], ["# depth images"], ["# ground truth"]
    for k in range(N_FRAMES):
        T = _camera_pose(k)
        I, D = render_plane(INTR, SHAPE, T)
        ts = 1000.0 + 0.05 * k
        cv2.imwrite(str(tum / "rgb" / f"{ts:.6f}.png"), (I * 255).astype(np.uint8))
        cv2.imwrite(str(tum / "depth" / f"{ts + 0.004:.6f}.png"), np.clip(D * 5000.0, 0, 65535).astype(np.uint16))
        rgb.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        dep.append(f"{ts + 0.004:.6f} depth/{ts + 0.004:.6f}.png")
        gt.append(format_pose_line(ts, np.linalg.inv(T)))
    for name, lines in (("rgb.txt", rgb), ("depth.txt", dep), ("groundtruth.txt", gt)):
        (tum / name).write_text("\n".join(lines) + "\n")
    raw = root / "raw"
    assert phovo_convert.main(["--dataset", str(tum), "--out", str(raw), "--loader", "python"]) == 0
    tight = root / "tight.yml"
    tight.write_text(TIGHT)
    return {"tum": tum, "raw": raw, "tight": tight, "root": root}


def _vo(args, out, config, dataset, *extra):
    """The port's phovo-vo on the CPU; returns the trajectory."""
    rc = phovo_vo.main(["--config", str(config), "--dataset", str(dataset), "--output", str(out), "--intrinsics",
                        SPEC, "--device", "cpu", "-q", *args, *extra])
    assert rc == 0
    return read_trajectory(out)


def _pose_lines(path) -> list:
    return [ln for ln in Path(path).read_text().splitlines() if ln.strip() and not ln.startswith("#")]


def _assert_poses_close(a, b, atol=POSE_ATOL):
    np.testing.assert_array_equal(a.timestamps, b.timestamps)
    for i in range(len(a)):
        np.testing.assert_allclose(a.pose_matrix(i), b.pose_matrix(i), rtol=0, atol=atol)


# phovo-vo against phovo_tpu's: (the port's flags, the config)
VO_CASES = {
    "frame": ([], "tight"),
    "frame-preset": ([], ANALYTIC),
    "chunk-analytic": (["--chunk", str(CHUNK)], ANALYTIC),
    "chunk-ceres": (["--chunk", str(CHUNK), "--backend", "ceres"], CERES),
    "keyframe": (["--mode", "keyframe"], "tight"),
}


@pytest.mark.parametrize("case", sorted(VO_CASES))
def test_vo_matches_phovo_tpu(data, tmp_path, case):
    from phovo_tpu.apps import phovo_vo as jax_vo

    flags, config = VO_CASES[case]
    config = data["tight"] if config == "tight" else config
    port = _vo([*flags, "--loader", "python"], tmp_path / "port.txt", config, data["tum"])
    rc = jax_vo.main(["--config", str(config), "--dataset", str(data["tum"]), "--output", str(tmp_path / "ref.txt"),
                      "--intrinsics", SPEC, "-q", "--loader", "python", *flags])
    assert rc == 0
    ref = read_trajectory(tmp_path / "ref.txt")
    assert len(port) == len(ref) == N_FRAMES - 1
    _assert_poses_close(port, ref)


def _chunk_entry(backend):
    """The backend's align_sequence_chunk* entry and its backend-specific
    argument, named here rather than taken from the CLI's dispatch."""
    from phovo_tpu_torch.models.analytic import align_sequence_chunk
    from phovo_tpu_torch.models.autodiff import align_sequence_chunk_autodiff
    from phovo_tpu_torch.models.biobjective import align_sequence_chunk_biobjective
    from phovo_tpu_torch.models.ic import align_sequence_chunk_ic

    return {"analytic": (align_sequence_chunk, True), "autodiff": (align_sequence_chunk_autodiff, "linearizer"),
            "ceres": (align_sequence_chunk_autodiff, "linearizer"), "ic": (align_sequence_chunk_ic, True),
            "biobjective": (align_sequence_chunk_biobjective, True)}[backend]


def _chain_lines(backend, raw, config, chunk):
    """The lines phovo-vo --chunk writes, computed in process: the
    backend's chunked entry over the raw frames' chunks (uint8 and uint16,
    the carry kept), the poses integrated on the host."""
    fn, arg = _chunk_entry(backend)
    I8, D16 = np.load(raw / "intensity.u8.npy"), np.load(raw / "depth.u16.npy")
    ts = np.load(raw / "timestamps.f64.npy")
    scale = json.loads((raw / "meta.json").read_text())["depth_scale"]
    cfg = load_config(config)
    carry_i = torch.from_numpy(I8[0])
    carry_d = torch.from_numpy(D16[0]).to(torch.float32) * float(np.float32(scale))
    pose, lines = np.eye(4), []
    for lo in range(1, len(I8), chunk):
        res, carry_i, carry_d = fn(carry_i, carry_d, torch.from_numpy(I8[lo:lo + chunk]),
                                   torch.from_numpy(D16[lo:lo + chunk]), INTR, cfg, arg, False, scale)
        for k, state in enumerate(res.state.numpy()):
            pose = pose @ np.linalg.inv(se3.pose_matrix_np(state))
            lines.append(format_pose_line(ts[lo + k], pose))
    return lines


@pytest.mark.parametrize("backend", ["analytic", "autodiff", "ceres", "biobjective", "ic"])
def test_chunked_cli_is_the_in_process_chain(data, tmp_path, backend):
    """Each backend's --chunk run is its own entry's chain; the backends
    that share a preset (analytic, biobjective, ic) write trajectories of
    their own, so a CLI that dispatched one to another's entry fails."""
    out = tmp_path / "t.txt"
    config = ANALYTIC if backend in ("analytic", "biobjective", "ic") else CERES
    _vo(["--chunk", str(CHUNK), "--backend", backend, "--loader", "raw"], out, config, data["raw"])
    lines = _pose_lines(out)
    assert lines == _chain_lines(backend, data["raw"], config, CHUNK)
    if config == ANALYTIC:
        for other in {"analytic", "biobjective", "ic"} - {backend}:
            assert lines != _chain_lines(other, data["raw"], config, CHUNK), other


def test_raw_loader_gives_the_png_loaders_lines(data, tmp_path):
    """uint16 counts scaled on the device give the host's float32 depth:
    the same trajectory, line for line."""
    a = tmp_path / "raw.txt"
    b = tmp_path / "png.txt"
    _vo(["--chunk", str(CHUNK), "--loader", "raw"], a, data["tight"], data["raw"])
    _vo(["--chunk", str(CHUNK), "--loader", "python"], b, data["tight"], data["tum"])
    assert _pose_lines(a) == _pose_lines(b)


def test_native_loader_gives_the_cv2_loaders_poses(data, tmp_path):
    if not native_loader.available():
        r = subprocess.run(["make", "-C", str(REPO / "native"), "libphovo_io.so"], capture_output=True, text=True)
        if r.returncode != 0 or not native_loader.available():
            pytest.skip(f"cannot build native loader: {r.stderr[-500:]}")
    a = _vo(["--chunk", str(CHUNK), "--loader", "native"], tmp_path / "n.txt", data["tight"], data["tum"])
    b = _vo(["--chunk", str(CHUNK), "--loader", "python"], tmp_path / "p.txt", data["tight"], data["tum"])
    _assert_poses_close(a, b, atol=1e-5)


def test_chunked_resume_continues_the_trajectory(data, tmp_path):
    """Cut after 3 pairs with a checkpoint, resumed: the uninterrupted
    run's poses. The resumed run's chunks hold other pairs, and the plain
    CPU version's batched sums round with the batch's size (~1e-7), so the
    poses are held to 1e-6."""
    full = tmp_path / "full.txt"
    _vo(["--chunk", "2", "--loader", "raw"], full, data["tight"], data["raw"])
    part, ckpt = tmp_path / "part.txt", tmp_path / "ckpt.json"
    _vo(["--chunk", "2", "--loader", "raw", "--checkpoint", str(ckpt), "--max-frames", "3"], part, data["tight"],
        data["raw"])
    assert len(_pose_lines(part)) == 3 and json.loads(ckpt.read_text())["frame_index"] == 3
    resumed = _vo(["--chunk", "2", "--loader", "raw", "--checkpoint", str(ckpt), "--resume"], part, data["tight"],
                  data["raw"])
    assert _pose_lines(part)[:3] == _pose_lines(full)[:3]
    _assert_poses_close(resumed, read_trajectory(full), atol=1e-6)


def test_frame_mode_resume_continues_from_the_checkpoint(data, tmp_path):
    from phovo_tpu_torch.models import BACKENDS
    from phovo_tpu_torch.models.sequence import Checkpoint, VisualOdometryPipeline
    from phovo_tpu_torch.datasets.raw import RawSequence

    full = tmp_path / "full.txt"
    _vo(["--loader", "raw"], full, data["tight"], data["raw"])
    vo = BACKENDS["analytic"](load_config(data["tight"]), device="cpu")
    vo.set_intrinsic_matrix([[INTR.fx, 0, INTR.cx], [0, INTR.fy, INTR.cy], [0, 0, 1]])
    pipe = VisualOdometryPipeline(vo)
    frames = list(RawSequence(data["raw"]))
    results = list(pipe.run(frames[:4]))
    ckpt = tmp_path / "ckpt.json"
    Checkpoint(pipe.frame_index, results[-1].global_pose, results[-1].relative_state).save(ckpt)
    resumed = tmp_path / "resumed.txt"
    _vo(["--loader", "raw", "--checkpoint", str(ckpt), "--resume"], resumed, data["tight"], data["raw"])
    assert _pose_lines(resumed) == _pose_lines(full)[3:]


@pytest.mark.parametrize("chunk", ["1", str(CHUNK)])
def test_metrics_log_a_line_a_pair(data, tmp_path, chunk):
    m = tmp_path / "m.jsonl"
    _vo(["--chunk", chunk, "--loader", "raw", "--metrics", str(m)], tmp_path / "t.txt", data["tight"], data["raw"])
    records = [json.loads(ln) for ln in m.read_text().splitlines()]
    assert [r["frame"] for r in records] == list(range(1, N_FRAMES))
    assert all(len(r["relative_state"]) == 6 and r["align_seconds"] >= 0 for r in records)


def test_warm_start_and_eval_gt(data, tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        est = phovo_vo.main(["--config", str(data["tight"]), "--dataset", str(data["raw"]), "--output",
                             str(tmp_path / "t.txt"), "--intrinsics", SPEC, "--device", "cpu", "-q", "--warm-start",
                             "--eval-gt", str(data["tum"] / "groundtruth.txt")])
    assert est == 0
    ate = float(re.search(r"ATE rmse: ([\d.]+) m", buf.getvalue())[1])
    assert ate < 0.01


def test_keyframe_mode_chunked_runs_on_the_raw_frames(data, tmp_path):
    t = _vo(["--mode", "keyframe", "--chunk", str(CHUNK), "--loader", "raw", "--kf-translation", "0.02"],
            tmp_path / "t.txt", data["tight"], data["raw"])
    assert len(t) == N_FRAMES - 1 and np.isfinite(t.positions).all()


def _json_out(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue())


@pytest.mark.parametrize("flags", [[], ["--mode", "ate"], ["--mode", "rpe", "--rpe-delta", "2"],
                                   ["--max-dt", "0.001"]])
def test_eval_json_matches_phovo_tpu(data, tmp_path, flags):
    from phovo_tpu.apps import phovo_eval as jax_eval

    est = tmp_path / "t.txt"
    _vo(["--loader", "raw"], est, data["tight"], data["raw"])
    gt = data["tum"] / "groundtruth.txt"
    port = _json_out(phovo_eval.main, [str(gt), str(est), "--json", *flags])
    ref = _json_out(jax_eval.main, [str(gt), str(est), "--json", *flags])
    assert port == ref


def test_eval_text_report(data, tmp_path, capsys):
    gt = data["tum"] / "groundtruth.txt"
    assert phovo_eval.main([str(gt), str(gt)]) == 0
    out = capsys.readouterr().out
    assert "ATE over 7 associated poses" in out and "rot rmse" in out


def test_convert_cli_writes_phovo_tpus_files(data, tmp_path):
    from phovo_tpu.apps import phovo_convert as jax_convert

    assert phovo_convert.main(["--dataset", str(data["tum"]), "--out", str(tmp_path / "p"), "--loader", "python",
                               "--max-frames", "5"]) == 0
    assert jax_convert.main(["--dataset", str(data["tum"]), "--out", str(tmp_path / "r"), "--loader", "python",
                             "--max-frames", "5"]) == 0
    for f in sorted((tmp_path / "r").iterdir()):
        assert (tmp_path / "p" / f.name).read_bytes() == f.read_bytes(), f.name


def _align_state(main, argv) -> np.ndarray:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    text = buf.getvalue().split("state vector (x y z yaw pitch roll):")[1].split("Rt:")[0]
    return np.array([float(v) for v in text.replace("[", " ").replace("]", " ").split()])


@pytest.mark.parametrize("backend", ["analytic", "ceres", "biobjective", "ic"])
def test_align_matches_phovo_tpu(data, backend):
    from phovo_tpu.apps import phovo_align as jax_align

    rgb = sorted((data["tum"] / "rgb").iterdir())
    dep = sorted((data["tum"] / "depth").iterdir())
    pair = [str(rgb[0]), str(dep[0]), str(rgb[1]), str(dep[1])]
    args = [str(data["tight"]), *pair, "--backend", backend, "--intrinsics", SPEC, "--depth-scale", "0.0002"]
    port = _align_state(phovo_align.main, [*args, "--device", "cpu"])
    ref = _align_state(jax_align.main, args)
    np.testing.assert_allclose(port, ref, rtol=0, atol=POSE_ATOL)


def test_align_reads_npy_frames_as_their_pngs(data, tmp_path):
    rgb = sorted((data["tum"] / "rgb").iterdir())
    dep = sorted((data["tum"] / "depth").iterdir())
    npys = []
    for path, flag in ((rgb[0], cv2.IMREAD_GRAYSCALE), (dep[0], cv2.IMREAD_UNCHANGED), (rgb[1], cv2.IMREAD_GRAYSCALE),
                       (dep[1], cv2.IMREAD_UNCHANGED)):
        npys.append(tmp_path / f"{len(npys)}.npy")
        np.save(npys[-1], cv2.imread(str(path), flag))
    common = ["--intrinsics", SPEC, "--depth-scale", "0.0002", "--device", "cpu"]
    png = _align_state(phovo_align.main, [str(data["tight"]), str(rgb[0]), str(dep[0]), str(rgb[1]), str(dep[1]),
                                          *common])
    npy = _align_state(phovo_align.main, [str(data["tight"]), *map(str, npys), *common])
    np.testing.assert_array_equal(png, npy)


def _assert_served_streams_are_their_own_vo_runs(data, tmp_path, chunk, exact=True):
    """Two streams (the fixture, and its first 5 frames: padded in a later
    round) served in one batch a round, `chunk` new frames a stream: each
    stream's trajectory is its own phovo-vo --chunk run's, line for line
    (exact), or within POSE_ATOL."""
    from phovo_tpu_torch.datasets.raw import convert_to_raw

    short = convert_to_raw(data["tum"], tmp_path / "short", loader="python", max_frames=5)
    streams = [data["raw"], short]
    singles = []
    for k, d in enumerate(streams):
        singles.append(tmp_path / f"single{k}.txt")
        _vo(["--chunk", str(chunk)], singles[-1], data["tight"], d)
    out = tmp_path / "served"
    rc = phovo_serve.main(["--config", str(data["tight"]), "--dataset", str(streams[0]), "--dataset",
                           str(streams[1]), "--out-dir", str(out), "--chunk", str(chunk), "--intrinsics", SPEC,
                           "--device", "cpu", "-q"])
    assert rc == 0
    for d, single in zip(streams, singles):
        if exact:
            assert _pose_lines(out / f"{d.name}.txt") == _pose_lines(single)
        else:
            _assert_poses_close(read_trajectory(out / f"{d.name}.txt"), read_trajectory(single))


def test_serve_two_streams_are_their_own_vo_runs(data, tmp_path):
    _assert_served_streams_are_their_own_vo_runs(data, tmp_path, CHUNK)


def test_serve_two_streams_one_frame_rounds_are_their_own_vo_runs(data, tmp_path):
    """--chunk 1: one new frame a stream a round, one pair a stream. The
    level kernel's plain version rounds its batched sums with the batch
    (here 2 pairs a level against phovo-vo's 1; ~4e-8 in a pose entry), so
    the CPU holds the poses to POSE_ATOL; on the card they are the same
    bits."""
    _assert_served_streams_are_their_own_vo_runs(data, tmp_path, 1, exact=False)


# phovo-vo's bundle-adjustment flags, one set a case, each run with
# --ba-iterations 2 so that the refinement runs
BA_FLAG_SETS = {
    "iterations": [],
    "export-map": ["--export-map", "map.ply"],
    "window": ["--ba-window", "3"],
    "scope": ["--ba-scope", "global"],
    "covis": ["--ba-scope", "global", "--ba-covis", "1"],
    "grid": ["--ba-grid", "4"],
    "occlusion-gate": ["--ba-occlusion-gate", "0"],
    "z-robust-delta": ["--ba-z-robust-delta", "0.05"],
    "robust-delta": ["--ba-robust-delta", "0"],
}
# keyframe mode with a keyframe every few frames of the fixture
KF_FLAGS = ["--mode", "keyframe", "--kf-translation", "0.02"]


@pytest.fixture(scope="module")
def kf_tracked(data):
    """The port's keyframe tracker run in process over the raw fixture as
    phovo-vo --mode keyframe runs it (the per-frame run()), before
    finalize: (the tracker, its keyframe poses)."""
    from phovo_tpu_torch.datasets.raw import RawSequence
    from phovo_tpu_torch.models import BACKENDS
    from phovo_tpu_torch.models.keyframe import KeyframeVisualOdometry

    vo = BACKENDS["analytic"](load_config(data["tight"]), device="cpu")
    vo.set_intrinsic_matrix(INTR.matrix())
    kvo = KeyframeVisualOdometry(vo, kf_translation=0.02)
    list(kvo.run(iter(RawSequence(data["raw"]))))
    assert len(kvo.keyframes) >= 3
    return kvo, [k.pose.copy() for k in kvo.keyframes]


@pytest.mark.parametrize("case", list(BA_FLAG_SETS))
def test_ba_flags_give_the_in_process_finalize(data, tmp_path, kf_tracked, case):
    """Each bundle-adjustment flag set through phovo-vo --mode keyframe:
    the trajectory is the in-process tracker's finalize with the kwargs the
    flags name, line for line; --export-map writes its map."""
    flags = [str(tmp_path / f) if f == "map.ply" else f for f in BA_FLAG_SETS[case]]
    argv = [*KF_FLAGS, "--loader", "raw", "--ba-iterations", "2", *flags]
    out = tmp_path / "t.txt"
    _vo(argv, out, data["tight"], data["raw"])
    args = phovo_vo.build_parser().parse_args(["-c", "c", "-d", "d", "-o", "o", *argv])
    kvo, snap = kf_tracked
    for kf, pose in zip(kvo.keyframes, snap):
        kf.pose = pose.copy()
    tracked = kvo.finalize(ba_iterations=args.ba_iterations, ba_window=args.ba_window, ba_grid=args.ba_grid,
                           ba_robust_delta=args.ba_robust_delta, ba_scope=args.ba_scope, ba_covis=args.ba_covis,
                           ba_occ_gate=args.ba_occlusion_gate, ba_z_robust_delta=args.ba_z_robust_delta)
    assert _pose_lines(out) == [format_pose_line(tf.timestamp, tf.pose) for tf in tracked]
    assert kvo.map_points is not None and len(kvo.map_points) > 0
    if args.export_map:
        head = Path(args.export_map).read_text().splitlines()
        assert f"element vertex {len(kvo.map_points)}" in head


@pytest.mark.parametrize("flags", [[], ["--ba-scope", "global", "--export-map", "map.ply"]], ids=["window", "global"])
def test_ba_cli_matches_phovo_tpu(data, tmp_path, flags):
    """phovo-vo --mode keyframe --ba-iterations 2 against phovo_tpu's on the
    same TUM directory: poses within 1e-4 (measured 6.2e-6 windowed and
    2.8e-5 global, from tracked poses 1.3e-7 apart: two LM iterations at
    the production damping amplify float32 differences) and the same map
    size."""
    from phovo_tpu.apps import phovo_vo as jax_vo

    flags = [str(tmp_path / "port.ply") if f == "map.ply" else f for f in flags]
    argv = [*KF_FLAGS, "--loader", "python", "--ba-iterations", "2", *flags]
    port = _vo(argv, tmp_path / "port.txt", data["tight"], data["tum"])
    ref_flags = [str(tmp_path / "ref.ply") if f.endswith("port.ply") else f for f in argv]
    assert jax_vo.main(["--config", str(data["tight"]), "--dataset", str(data["tum"]), "--output",
                        str(tmp_path / "ref.txt"), "--intrinsics", SPEC, "-q", *ref_flags]) == 0
    ref = read_trajectory(tmp_path / "ref.txt")
    assert len(port) == len(ref) == N_FRAMES - 1
    _assert_poses_close(port, ref)
    if "--export-map" in flags:  # the header (its vertex count) is phovo_tpu's
        heads = [(tmp_path / f).read_text().splitlines()[:3] for f in ("port.ply", "ref.ply")]
        assert heads[0] == heads[1]


def test_export_map_without_ba_writes_no_map(data, tmp_path, capsys):
    _vo([*KF_FLAGS, "--loader", "raw", "--export-map", str(tmp_path / "m.ply")], tmp_path / "t.txt", data["tight"],
        data["raw"])
    assert "no map written" in capsys.readouterr().err and not (tmp_path / "m.ply").exists()


@pytest.mark.parametrize("devices,message", [
    ("2", "needs 2 ranks.*world size 1"),
    ("3", "2 streams not divisible by --devices 3"),
])
def test_unported_flags_raise_naming_their_roadmap_item(data, tmp_path, capsys, devices, message):
    """phovo-serve --devices over 2 streams in one process: 2 cards need 2
    ranks (ValueError naming both numbers, exit 1 through main); 3 does
    not divide the streams (phovo_tpu's message, exit 1). Nothing is
    written."""
    argv = ["--config", str(data["tight"]), "--dataset", str(data["raw"]), "--dataset", str(data["raw"]),
            "--out-dir", str(tmp_path / "out"), "--devices", devices, "--device", "cpu"]
    if devices == "2":
        with pytest.raises(ValueError, match=message):
            phovo_serve._main(argv)
    assert phovo_serve.main(argv) == 1
    assert re.search(message, capsys.readouterr().err) and not (tmp_path / "out").exists()


@pytest.mark.parametrize("name", ["phovo_vo", "phovo_align", "phovo_serve"])
def test_default_device_is_the_card_and_raises_without_one(data, tmp_path, monkeypatch, name):
    """The CLIs that launch kernels run on the card unless told otherwise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rgb = sorted((data["tum"] / "rgb").iterdir())
    dep = sorted((data["tum"] / "depth").iterdir())
    argv = {
        "phovo_vo": ["--config", str(data["tight"]), "--dataset", str(data["raw"]), "--output", str(tmp_path / "t")],
        "phovo_align": [str(data["tight"]), str(rgb[0]), str(dep[0]), str(rgb[1]), str(dep[1])],
        "phovo_serve": ["--config", str(data["tight"]), "--dataset", str(data["raw"]), "--out-dir", str(tmp_path)],
    }[name]
    cli = {"phovo_vo": phovo_vo, "phovo_align": phovo_align, "phovo_serve": phovo_serve}[name]
    assert "--device" in cli.build_parser().format_help()
    with pytest.raises(RuntimeError, match="no CUDA card; pass --device cpu"):
        cli.main(argv)
    assert not (tmp_path / "t").exists()


@pytest.mark.parametrize("name", ["phovo_eval", "phovo_convert"])
def test_host_clis_take_no_device_and_run_without_a_card(data, tmp_path, monkeypatch, name):
    """phovo-eval and phovo-convert do all their work on the host: they
    take no --device and run where torch finds no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gt = str(data["tum"] / "groundtruth.txt")
    cli, argv = {
        "phovo_eval": (phovo_eval, [gt, gt, "--json"]),
        "phovo_convert": (phovo_convert, ["--dataset", str(data["tum"]), "--out", str(tmp_path / "raw"), "--loader",
                                          "python", "--max-frames", "2"]),
    }[name]
    assert "--device" not in cli.build_parser().format_help()
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(argv) == 0
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args([*argv, "--device", "cpu"])


def test_band_fallback_and_mix_mode_are_accepted_and_change_nothing(data, tmp_path):
    a = tmp_path / "a.txt"
    b = tmp_path / "b.txt"
    _vo(["--chunk", str(CHUNK)], a, data["tight"], data["raw"])
    _vo(["--chunk", str(CHUNK), "--band-fallback", "0.5", "--mix-mode", "bf16"], b, data["tight"], data["raw"])
    assert _pose_lines(a) == _pose_lines(b)
    help_text = phovo_vo.build_parser().format_help()
    assert "whole target" in help_text and "float32" in help_text


def test_clis_run_as_modules_and_import_without_jax_cv2_or_pyyaml(data, tmp_path):
    """`python -m phovo_tpu_torch.apps.phovo_eval` runs, and every module of
    the package imports with jax, cv2 and pyyaml blocked (the machine with
    the card has none of them)."""
    gt = str(data["tum"] / "groundtruth.txt")
    done = subprocess.run([sys.executable, "-m", "phovo_tpu_torch.apps.phovo_eval", gt, gt, "--json"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert done.returncode == 0 and json.loads(done.stdout)["ate"]["rmse"] < 1e-9
    modules = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                     for p in (REPO / "phovo_tpu_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        "for blocked in ('jax', 'cv2', 'yaml'):\n"
        "    sys.modules[blocked] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "from phovo_tpu_torch.utils.config import load_builtin\n"
        "load_builtin('config_5_level_optimization_ceres')\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'phovo_tpu', 'cv2', 'yaml')]\n"
        "assert sorted(loaded) == ['cv2', 'jax', 'yaml'], loaded\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_trajectory_writer_and_reader_round_trip(tmp_path):
    T = se3.pose_matrix_np(np.array([0.1, 0.2, 0.3, 0.4, -0.2, 0.1]))
    p = tmp_path / "t.txt"
    with TrajectoryWriter(p) as w:
        w.write(1234.5678, T)
    with TrajectoryWriter(p, append=True) as w:
        w.write(1235.0, np.eye(4))
    t = read_trajectory(p)
    assert len(t) == 2 and p.read_text().count("#") == 2
    np.testing.assert_allclose(t.pose_matrix(0), T, atol=1e-6)


# -- the difference images -----------------------------------------------------

# the two packages' states differ by float32 noise (~1e-6), which can move a
# forward-warped pixel across a truncation boundary: a few pixels may differ
DIFF_PIXELS_EQUAL = 0.99


def _assert_images_agree(port_dir, ref_dir, pattern):
    port, ref = sorted(Path(port_dir).glob(pattern)), sorted(Path(ref_dir).glob(pattern))
    assert [p.name for p in port] == [p.name for p in ref] and port
    for a, b in zip(port, ref):
        img, want = cv2.imread(str(a), cv2.IMREAD_UNCHANGED), cv2.imread(str(b), cv2.IMREAD_UNCHANGED)
        assert img.dtype == np.uint8 and img.shape == want.shape == SHAPE
        assert (img == want).mean() >= DIFF_PIXELS_EQUAL, a.name
    return port


@pytest.fixture(scope="module")
def visualize_config(data):
    path = data["root"] / "visualize.yml"
    path.write_text(TIGHT.replace("max_iterations: [8, 8]", "max_iterations: [2, 3]") + "visualize_iterations: true\n")
    return path


def _npy_pair(data, tmp_path):
    """The fixture's first pair as the PNGs phovo_tpu's app reads and the
    .npy arrays of the same pixels for the port."""
    rgb = sorted((data["tum"] / "rgb").iterdir())
    dep = sorted((data["tum"] / "depth").iterdir())
    pngs = [rgb[0], dep[0], rgb[1], dep[1]]
    npys = []
    for path, flag in zip(pngs, (cv2.IMREAD_GRAYSCALE, cv2.IMREAD_UNCHANGED) * 2):
        npys.append(tmp_path / f"{len(npys)}.npy")
        np.save(npys[-1], cv2.imread(str(path), flag))
    return [str(p) for p in pngs], [str(p) for p in npys]


@pytest.mark.parametrize("backend", ["analytic", "biobjective"])
def test_align_save_diffs_match_phovo_tpu(data, tmp_path, visualize_config, backend):
    """--save-diff (|target - warped source| at the result, u8) and
    --save-diff-dir (one PNG a replayed iteration) write phovo_tpu's
    images, the port reading .npy frames and phovo_tpu their PNGs."""
    from phovo_tpu.apps import phovo_align as jax_align

    pngs, npys = _npy_pair(data, tmp_path)
    common = ["--backend", backend, "--intrinsics", SPEC, "--depth-scale", "0.0002"]
    out = {}
    for name, main, frames, extra in (("port", phovo_align.main, npys, ["--device", "cpu"]),
                                      ("jax", jax_align.main, pngs, [])):
        d = tmp_path / name
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([str(visualize_config), *frames, *common, "--save-diff", str(d / "diff.png"),
                         "--save-diff-dir", str(d / "iters"), *extra]) == 0
        out[name] = buf.getvalue()
        assert "wrote 5 per-iteration diff images" in out[name] and "wrote difference image" in out[name]
    paths = _assert_images_agree(tmp_path / "port" / "iters", tmp_path / "jax" / "iters", "*.png")
    assert [p.name for p in paths] == ["level0_iter001.png", "level0_iter002.png", "level1_iter001.png",
                                       "level1_iter002.png", "level1_iter003.png"]
    _assert_images_agree(tmp_path / "port", tmp_path / "jax", "diff.png")


def test_align_save_diff_is_alignment_diff_at_the_result(data, tmp_path):
    """The --save-diff PNG is alignment_diff at the state the run prints,
    truncated to u8."""
    from phovo_tpu_torch.utils.viz import alignment_diff

    _, npys = _npy_pair(data, tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert phovo_align.main([str(data["tight"]), *npys, "--intrinsics", SPEC, "--depth-scale", "0.0002",
                                 "--save-diff", str(tmp_path / "d.png"), "--device", "cpu"]) == 0
    text = buf.getvalue().split("Rt:")[0].split("state vector (x y z yaw pitch roll):")[1]
    state = np.array([float(v) for v in text.replace("[", " ").replace("]", " ").split()], np.float32)
    src_i, src_d, tgt_i = np.load(npys[0]), np.load(npys[1]) * np.float32(0.0002), np.load(npys[2])
    want = alignment_diff(src_i, src_d, tgt_i, state, INTR, device="cpu").astype(np.uint8)
    got = cv2.imread(str(tmp_path / "d.png"), cv2.IMREAD_UNCHANGED)
    assert (got == want).mean() >= DIFF_PIXELS_EQUAL  # the printed state is rounded to 8 digits
    assert 0 < np.count_nonzero(got) and np.median(got[got > 0]) < 40  # converged: dark where the warp lands


@pytest.mark.parametrize("backend,config,note", [
    ("ceres", "visualize", "not supported for backend 'ceres'"),
    ("analytic", "tight", "needs visualizeIterations: true"),
])
def test_align_save_diff_dir_notes(data, tmp_path, visualize_config, capsys, backend, config, note):
    _, npys = _npy_pair(data, tmp_path)
    cfg = visualize_config if config == "visualize" else data["tight"]
    assert phovo_align.main([str(cfg), *npys, "--backend", backend, "--intrinsics", SPEC, "--depth-scale", "0.0002",
                             "--save-diff-dir", str(tmp_path / "iters"), "--device", "cpu"]) == 0
    assert note in capsys.readouterr().err and not (tmp_path / "iters").exists()


def test_vo_save_diff_dir_matches_phovo_tpu(data, tmp_path):
    """Frame mode writes one diff_NNNNNN.png a pair (0..255: u8 frames),
    phovo_tpu's images."""
    from phovo_tpu.apps import phovo_vo as jax_vo

    _vo(["--loader", "python", "--save-diff-dir", str(tmp_path / "port")], tmp_path / "p.txt", data["tight"],
        data["tum"])
    assert jax_vo.main(["--config", str(data["tight"]), "--dataset", str(data["tum"]), "--output",
                        str(tmp_path / "r.txt"), "--intrinsics", SPEC, "-q", "--loader", "python",
                        "--save-diff-dir", str(tmp_path / "jax")]) == 0
    paths = _assert_images_agree(tmp_path / "port", tmp_path / "jax", "diff_*.png")
    assert [p.name for p in paths] == [f"diff_{k:06d}.png" for k in range(1, N_FRAMES)]


def test_vo_save_diff_dir_on_the_raw_frames(data, tmp_path):
    """On the raw layout (the card's input) the images are the python
    loader's: the same u8 intensity, depth the same metres."""
    _vo(["--loader", "raw", "--save-diff-dir", str(tmp_path / "raw")], tmp_path / "a.txt", data["tight"], data["raw"])
    _vo(["--loader", "python", "--save-diff-dir", str(tmp_path / "png")], tmp_path / "b.txt", data["tight"],
        data["tum"])
    assert len(_assert_images_agree(tmp_path / "raw", tmp_path / "png", "diff_*.png")) == N_FRAMES - 1


@pytest.mark.parametrize("mode", ["chunk", "keyframe"])
def test_vo_save_diff_dir_notes_where_it_writes_nothing(data, tmp_path, capsys, mode):
    flags = ["--chunk", str(CHUNK)] if mode == "chunk" else ["--mode", "keyframe"]
    _vo([*flags, "--loader", "raw", "--save-diff-dir", str(tmp_path / "d")], tmp_path / "t.txt", data["tight"],
        data["raw"])
    err = capsys.readouterr().err
    assert "--save-diff-dir" in err and ("--chunk 1" in err if mode == "chunk" else "not supported in keyframe mode"
                                         in err)
    assert not any((tmp_path / "d").glob("*.png"))
