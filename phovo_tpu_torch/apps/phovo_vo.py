"""CLI: visual odometry over a TUM RGB-D sequence (torch port of
phovo_tpu/apps/phovo_vo.py; the reference app
PhotoconsistencyVisualOdometry).

    python -m phovo_tpu_torch.apps.phovo_vo --config cfg.yml --dataset DIR \
        --output trajectory.txt [--backend analytic|ceres|autodiff|biobjective|ic] \
        [--intrinsics fr1] [--pairing associate|lockstep] [--loader auto|raw|native|python] \
        [--chunk N] [--mode frame|keyframe] [--warm-start] [--max-frames N] \
        [--checkpoint ckpt.json] [--resume] [--metrics m.jsonl] [--eval-gt gt.txt] \
        [--ba-iterations N] [--ba-scope window|global] [--export-map map.ply] [--save-diff-dir DIR] \
        [--device cuda]

Writes a TUM-format trajectory ('timestamp tx ty tz qx qy qz qw'). Three
modes, as phovo_tpu's:
  * frame mode (--chunk 1): each pair through the backend's object API
    (models/sequence.py::VisualOdometryPipeline), with --warm-start,
    --checkpoint/--resume, --metrics and --save-diff-dir (one
    |target - warped source| PNG a pair, diff_NNNNNN.png);
  * --chunk N: N frames a dispatch through the backend's
    align_sequence_chunk* entry; the carry frame stays on the device and
    the frames go up in their storage dtype (uint8 intensity; uint16 depth
    counts from the raw format, scaled on the device); the host integrates
    a chunk's poses while the next chunk is dispatched;
  * --mode keyframe: models/keyframe.py::KeyframeVisualOdometry (run, or
    run_chunked with --chunk N for the analytic and ceres backends), its
    pose graph and, with --ba-iterations N, its photometric bundle
    adjustment (--ba-*; --export-map writes the landmark map as PLY), with
    --kf-*, --pg-solver and --pg-incremental.
Defaults mirror the reference: fr1 intrinsics, depth scale 1/5000, every
pair from zero. Everything runs on --device, the CUDA card unless the
caller names another (an error where torch finds none). The card's
machine has no cv2: give it a sequence converted by phovo-convert (the
raw format, --loader raw or auto) or the libpng loader (--loader native).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np

from phovo_tpu_torch.apps._common import add_device_argument, resolve_device, to_device
from phovo_tpu_torch.apps.phovo_align import BACKEND_NAMES, parse_intrinsics

NO_EFFECT = "accepted and without effect in the port"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="phovo-vo", description="Photoconsistency visual odometry (TUM RGB-D)")
    p.add_argument("--config", "-c", required=True)
    p.add_argument("--dataset", "-d", required=True,
                   help="TUM sequence dir containing rgb.txt/depth.txt, or a phovo-convert raw dir")
    p.add_argument("--output", "-o", required=True, help="output trajectory file")
    p.add_argument("--backend", default="analytic", choices=BACKEND_NAMES)
    p.add_argument("--intrinsics", default="fr1", help="named preset (default/fr1/fr2/fr3) or 'fx,fy,cx,cy'")
    p.add_argument("--depth-scale", type=float, default=1.0 / 5000.0)
    p.add_argument("--pairing", default="associate", choices=["associate", "lockstep"])
    p.add_argument("--loader", default="auto", choices=["auto", "native", "python", "raw"],
                   help="dataset reader: the raw memmap replay (phovo-convert output, found by its meta.json), "
                        "the libpng decode-ahead loader (native/libphovo_io.so), the cv2 one (python), or auto: "
                        "raw for a raw dir, else native where it loads, else python")
    p.add_argument("--warm-start", action="store_true", help="initialize each pair from the previous relative pose")
    p.add_argument("--mode", default="frame", choices=["frame", "keyframe"],
                   help="frame: frame-to-frame chaining; keyframe: track against keyframes with loop closure "
                        "and a final pose-graph optimization")
    p.add_argument("--chunk", type=int, default=1,
                   help="align N frames a dispatch (every backend; in keyframe mode chunked tracking, "
                        "analytic and ceres)")
    p.add_argument("--ba-iterations", type=int, default=0,
                   help="keyframe mode: after the pose graph, refine the keyframes with photometric bundle adjustment "
                        "for N Levenberg-Marquardt iterations (0 = off)")
    p.add_argument("--ba-window", type=int, default=8, help="keyframe window size for photometric BA")
    p.add_argument("--ba-scope", default="window", choices=["window", "global"],
                   help="photometric BA scope: sliding windows (dense-Schur scale) or ONE joint problem over all "
                        "keyframes with covisibility-limited observations (map scale; the Schur path turns sparse "
                        "where a dense W would not fit)")
    p.add_argument("--ba-covis", type=int, default=6,
                   help="global BA: observations per landmark (nearest keyframes by camera centre)")
    p.add_argument("--export-map", default=None,
                   help="keyframe mode with --ba-iterations > 0: write the BA-refined sparse landmark map as an ASCII "
                        "PLY point cloud (grey vertex colours from the landmarks' host intensities)")
    p.add_argument("--ba-grid", type=int, default=8,
                   help="landmarks per keyframe = grid*grid (one per cell at the cell's highest-gradient valid-depth "
                        "pixel)")
    p.add_argument("--ba-occlusion-gate", type=float, default=0.3,
                   help="keyframe mode: drop BA observations whose predicted and measured depths differ by more than "
                        "this many metres (the landmark is occluded in that frame); 0 disables")
    p.add_argument("--ba-z-robust-delta", type=float, default=0.02,
                   help="keyframe mode: Huber delta (metres) for the BA depth rows (caps depth-interpolation error "
                        "near edges that passes the occlusion gate); 0 disables")
    p.add_argument("--ba-robust-delta", type=float, default=0.1,
                   help="keyframe mode: Huber delta for the BA photometric rows (intensity units; caps occluded or "
                        "edge-contaminated observations); 0 disables")
    p.add_argument("--pg-solver", default="auto", choices=["auto", "dense", "cg"],
                   help="keyframe mode: pose-graph solver, dense block Hessian, matrix-free block-Jacobi PCG, or "
                        "auto (dense up to 192 keyframes)")
    p.add_argument("--pg-incremental", type=int, default=0,
                   help="keyframe mode: re-solve the pose graph every N promotions (0: at the end only)")
    p.add_argument("--kf-translation", type=float, default=0.15,
                   help="keyframe mode: promote a new keyframe beyond this tracked translation (meters)")
    p.add_argument("--kf-rotation", type=float, default=0.15,
                   help="keyframe mode: promote a new keyframe beyond this tracked rotation (radians, euler norm)")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--checkpoint", default=None, help="checkpoint JSON path")
    p.add_argument("--resume", action="store_true", help="resume from --checkpoint if it exists")
    p.add_argument("--eval-gt", default=None, help="TUM groundtruth.txt to evaluate ATE/RPE against")
    p.add_argument("--metrics", default=None, help="write per-frame JSONL metrics to this file")
    p.add_argument("--save-diff-dir", default=None,
                   help="frame mode: write each aligned pair's |target - warped source| PNG into this directory")
    p.add_argument("--robust-loss", default=None, choices=["none", "huber", "cauchy", "tukey", "tdist"],
                   help="override the config's robust loss")
    p.add_argument("--robust-delta", type=float, default=None, help="override the config's robust loss delta")
    p.add_argument("--band-fallback", type=float, default=None,
                   help=f"{NO_EFFECT}: the GPU kernels sample the whole target, so no pixel is ever band-masked "
                        "and nothing re-runs")
    p.add_argument("--mix-mode", default=None, choices=["f32", "bf16x2g", "bf16x2", "bf16"],
                   help=f"{NO_EFFECT}: the port computes in float32")
    p.add_argument("--quiet", "-q", action="store_true")
    add_device_argument(p)
    return p


def main(argv=None) -> int:
    try:
        return _main(argv)
    except (FileNotFoundError, ValueError, IOError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def open_sequence(args):
    """The dataset reader --loader chooses: RawSequence for a raw dir (or
    --loader raw), the libpng loader where asked or, with auto, where it
    loads, else the cv2 reader. Returns None (after printing why) where the
    native loader is asked for and not built."""
    from phovo_tpu_torch.datasets import native_loader
    from phovo_tpu_torch.datasets import raw as raw_ds
    from phovo_tpu_torch.datasets.tum import TUMSequence

    use_raw = args.loader == "raw" or (args.loader == "auto" and raw_ds.is_raw_dir(args.dataset))
    use_native = not use_raw and (
        args.loader == "native" or (args.loader == "auto" and native_loader.available())
    )
    if use_raw:
        seq = raw_ds.RawSequence(args.dataset)
        # the raw layout bakes the depth scale and pairing in at conversion
        if abs(seq.depth_scale - args.depth_scale) > 1e-12:
            print(f"note: raw replay uses depth scale {seq.depth_scale} from meta.json (--depth-scale "
                  f"{args.depth_scale} ignored; re-run phovo-convert to change it)", file=sys.stderr)
        if seq.meta.get("pairing", args.pairing) != args.pairing:
            print(f"note: raw replay was converted with pairing={seq.meta.get('pairing')} (--pairing ignored)",
                  file=sys.stderr)
        return seq
    if use_native:
        if not native_loader.available():
            print("error: native loader requested but native/libphovo_io.so is not built (run `make -C native`)",
                  file=sys.stderr)
            return None
        return native_loader.NativeTUMSequence(
            args.dataset, depth_scale=args.depth_scale, pairing=args.pairing,
            prefetch=max(8, 2 * args.chunk + 2), threads=min(8, max(2, (os.cpu_count() or 4) - 2)),
        )
    return TUMSequence(args.dataset, depth_scale=args.depth_scale, pairing=args.pairing)


def _main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    from phovo_tpu_torch.datasets.tum import prefetch
    from phovo_tpu_torch.models import BACKENDS
    from phovo_tpu_torch.models.sequence import Checkpoint, VisualOdometryPipeline
    from phovo_tpu_torch.utils.config import load_config, override_config
    from phovo_tpu_torch.utils.trajectory import TrajectoryWriter

    cfg = override_config(load_config(args.config), mix_mode=args.mix_mode, robust_loss=args.robust_loss,
                          robust_delta=args.robust_delta)
    intr = parse_intrinsics(args.intrinsics)
    seq = open_sequence(args)
    if seq is None:
        return 1
    if len(seq) < 2:
        print("error: fewer than 2 paired frames in dataset", file=sys.stderr)
        return 1

    vo = BACKENDS[args.backend](cfg, device=device)
    vo.set_intrinsic_matrix(intr.matrix())
    if args.mode == "keyframe":
        return _run_keyframe_mode(args, vo, seq)
    if args.chunk > 1:
        return _run_chunked(args, cfg, intr, seq, device)

    pipeline = VisualOdometryPipeline(vo, warm_start=args.warm_start, checkpoint_path=args.checkpoint)
    if args.resume and args.checkpoint and Path(args.checkpoint).is_file():
        pipeline.resume(Checkpoint.load(args.checkpoint))
        if not args.quiet:
            print(f"resumed at frame {pipeline.frame_index}")
    metrics = None
    if args.metrics:
        from phovo_tpu_torch.utils.profiling import MetricsLogger

        metrics = MetricsLogger(args.metrics)
    diff_dir = None
    if args.save_diff_dir:
        diff_dir = Path(args.save_diff_dir)
        diff_dir.mkdir(parents=True, exist_ok=True)
    # the stream teed so a pair's difference image can read its two frames
    window: dict = {}

    def tee(stream):
        prev = None
        for f in stream:
            window["prev"], window["cur"] = prev, f
            prev = f
            yield f

    n_done = 0
    with TrajectoryWriter(args.output) as out:
        for fr in pipeline.run(tee(prefetch(iter(seq)))):
            out.write(fr.timestamp, fr.global_pose)
            n_done += 1
            if not args.quiet:
                print(f"frame {pipeline.frame_index}: {fr.align_seconds:.4f} s, iters {fr.iterations.tolist()}")
            if metrics is not None:
                metrics.log(frame=pipeline.frame_index, timestamp=fr.timestamp, align_seconds=fr.align_seconds,
                            iterations=fr.iterations, relative_state=fr.relative_state)
            if diff_dir is not None and window.get("prev") is not None:
                _save_pair_diff(diff_dir / f"diff_{pipeline.frame_index:06d}.png", window["prev"], window["cur"],
                                fr.relative_state, intr, device)
            if args.max_frames is not None and n_done >= args.max_frames:
                break
    if metrics is not None:
        metrics.close()
    if not args.quiet:
        print(f"wrote {n_done} poses to {args.output}")
    _maybe_eval(args)
    return 0


def _save_pair_diff(path, prev, cur, state, intr, device) -> None:
    """One pair's |target - warped source| PNG, in the frames' range: u8
    storage gives 0..255, unit-range float frames are scaled by 255."""
    from phovo_tpu_torch.utils.viz import alignment_diff, save_image

    src = np.asarray(prev.intensity)
    diff = alignment_diff(src, prev.depth, cur.intensity, state, intr, device=device)
    save_image(path, diff, unit_range=src.dtype != np.uint8 and float(src.max()) <= 1.5)


def _maybe_eval(args) -> None:
    if not args.eval_gt:
        return
    from phovo_tpu_torch.utils.trajectory import absolute_trajectory_error, read_trajectory, relative_pose_error

    est = read_trajectory(args.output)
    gt = read_trajectory(args.eval_gt)
    ate = absolute_trajectory_error(est, gt)
    rpe = relative_pose_error(est, gt)
    print(f"ATE rmse: {ate['rmse']:.4f} m (over {ate['num_pairs']} pairs)")
    print(f"RPE rmse: {rpe['trans_rmse']:.4f} m / {rpe['rot_rmse_deg']:.3f} deg")


def chunk_entry(backend: str):
    """(the backend's chunked entry, its backend-specific positional
    argument): every entry takes (carry_i, carry_d, I, D, intr, cfg, that
    argument, warm_start, depth_scale)."""
    from phovo_tpu_torch.models.analytic import align_sequence_chunk
    from phovo_tpu_torch.models.autodiff import align_sequence_chunk_autodiff
    from phovo_tpu_torch.models.biobjective import align_sequence_chunk_biobjective
    from phovo_tpu_torch.models.ic import align_sequence_chunk_ic

    if backend in ("ceres", "autodiff"):
        return align_sequence_chunk_autodiff, "linearizer"
    return {"analytic": align_sequence_chunk, "ic": align_sequence_chunk_ic,
            "biobjective": align_sequence_chunk_biobjective}[backend], True


def _trim_to_checkpoint(path: Path, keep: int) -> None:
    """Keep the file's header and its first `keep` poses: a run cut between
    two checkpoint saves can leave up to a chunk more, which the resumed
    run would write again."""
    kept, n_pose = [], 0
    for ln in path.read_text().splitlines():
        if ln.strip() and not ln.lstrip().startswith("#"):
            if n_pose >= keep:
                continue
            n_pose += 1
        kept.append(ln)
    path.write_text("\n".join(kept) + ("\n" if kept else ""))


def _chunk_stream(seq, chunk: int, skip: int):
    """(I (m, H, W), D (m, H, W), timestamps) host chunks in their storage
    dtype; the first is the priming (carry) frame, with timestamps None.
    On --resume, the `skip` frames the checkpoint covers are passed over
    first, so the carry is the last of them."""
    from phovo_tpu_torch.datasets.tum import prefetch

    if hasattr(seq, "read_chunk"):
        if hasattr(seq, "height"):  # random access (the raw replay)
            H, W = seq.height, seq.width
            left = skip
            while left > 0:
                Ii, _, _ = seq.read_chunk(min(left, chunk), H, W)
                if len(Ii) == 0:
                    return
                left -= len(Ii)
            Ii, Dd, _ = seq.read_chunk(1, H, W)
            if len(Ii) == 0:
                return
            yield Ii, Dd, None
        else:  # streaming (the libpng loader): prime by iterating
            it = iter(seq)
            first = None
            for _ in range(skip + 1):
                first = next(it, None)
                if first is None:
                    return
            H, W = first.intensity.shape
            yield first.intensity[None], first.depth[None], None
        while True:
            Ii, Dd, ts = seq.read_chunk(chunk, H, W)
            if len(Ii) == 0:
                return
            yield Ii, Dd, ts
    else:
        frames = prefetch(iter(seq))
        first = None
        for _ in range(skip + 1):
            first = next(frames, None)
            if first is None:
                return
        yield np.asarray(first.intensity)[None], np.asarray(first.depth, np.float32)[None], None
        while True:
            part = []
            for fr in frames:
                part.append(fr)
                if len(part) >= chunk:
                    break
            if not part:
                return
            yield (np.stack([np.asarray(f.intensity) for f in part]),
                   np.stack([np.asarray(f.depth, np.float32) for f in part]), [f.timestamp for f in part])


def _run_chunked(args, cfg, intr, seq, device) -> int:
    """Chunks of --chunk frames, one dispatch of the backend's chunked entry
    each. The carry frame (the last of each chunk) stays on the device, the
    new frames go up in their storage dtype, and the host integrates chunk
    k's poses (pose <- pose @ Rt^-1, float64) after chunk k + 1 is
    dispatched. A short last chunk runs as it is: on the card a pair's
    result does not depend on how many pairs share its launch (the
    kernels' layout is a function of the level's shape)."""
    import torch

    from phovo_tpu_torch.models.sequence import Checkpoint
    from phovo_tpu_torch.ops import se3
    from phovo_tpu_torch.utils.trajectory import TrajectoryWriter

    if args.save_diff_dir:
        print("note: --save-diff-dir is not supported with --chunk (frames stream through the device in storage "
              "dtype); use --chunk 1", file=sys.stderr)
    pose, n_done, skip = np.eye(4), 0, 0
    if args.resume and args.checkpoint and Path(args.checkpoint).is_file():
        ck = Checkpoint.load(args.checkpoint)
        pose = np.asarray(ck.global_pose, np.float64)
        n_done = skip = int(ck.frame_index)
        if Path(args.output).is_file():
            _trim_to_checkpoint(Path(args.output), skip)
        if not args.quiet:
            print(f"resumed at frame {n_done}")
    metrics = None
    if args.metrics:
        from phovo_tpu_torch.utils.profiling import MetricsLogger

        metrics = MetricsLogger(args.metrics)

    def integrate(states, timestamps, out, dt) -> bool:
        """Write a chunk's poses; True once --max-frames is reached."""
        nonlocal pose, n_done
        m = len(states)
        for k in range(m):
            pose = pose @ np.linalg.inv(se3.pose_matrix_np(states[k]))
            out.write(timestamps[k], pose)
            n_done += 1
            if metrics is not None:
                metrics.log(frame=n_done, timestamp=timestamps[k], align_seconds=dt / m, relative_state=states[k])
            if args.max_frames is not None and n_done >= args.max_frames:
                if args.checkpoint:
                    Checkpoint(n_done, pose, np.asarray(states[k])).save(args.checkpoint)
                return True
        if args.checkpoint:
            Checkpoint(n_done, pose, np.asarray(states[-1])).save(args.checkpoint)
        if not args.quiet:
            print(f"chunk of {m} pairs: {dt:.4f} s ({m / dt:.1f} pairs/s)")
        return False

    chunk_fn, backend_arg = chunk_entry(args.backend)
    raw_scale = float(seq.depth_scale) if getattr(seq, "depth_dtype", np.float32) == np.uint16 else None
    with TrajectoryWriter(args.output, append=skip > 0) as out:
        stream = _chunk_stream(seq, args.chunk, skip)
        prime = next(stream, None)
        if prime is None:
            return 0
        I0, D0, _ = prime
        carry_i = to_device(I0[0], device)
        carry_d = to_device(D0[0], device).to(torch.float32)
        if raw_scale is not None and D0.dtype == np.uint16:
            carry_d = carry_d * float(np.float32(raw_scale))
        pending = None  # (device states, timestamps, dispatch time)
        try:
            for Ii, Dd, ts in stream:
                t0 = time.perf_counter()
                res, carry_i, carry_d = chunk_fn(
                    carry_i, carry_d, to_device(Ii, device), to_device(Dd, device), intr, cfg, backend_arg,
                    args.warm_start, raw_scale if Dd.dtype == np.uint16 else None,
                )
                if pending is not None:
                    p_states, p_ts, p_t0 = pending
                    pending = None
                    if integrate(p_states.cpu().numpy(), p_ts, out, t0 - p_t0):
                        break
                pending = (res.state, ts, t0)
        finally:
            # the chunk already aligned is written even if a later chunk's
            # read or dispatch raises: the trajectory stays truncated, not holey
            if pending is not None:
                p_states, p_ts, p_t0 = pending
                integrate(p_states.cpu().numpy(), p_ts, out, time.perf_counter() - p_t0)
    if metrics is not None:
        metrics.close()
    if not args.quiet:
        print(f"wrote {n_done} poses to {args.output}")
    _maybe_eval(args)
    return 0


def _run_keyframe_mode(args, vo, seq) -> int:
    from phovo_tpu_torch.datasets.tum import RGBDFrame, prefetch
    from phovo_tpu_torch.models.autodiff import tr_track_levelmajor_eligible
    from phovo_tpu_torch.models.keyframe import KeyframeVisualOdometry
    from phovo_tpu_torch.utils.trajectory import TrajectoryWriter

    ignored = [name for name, on in [("--warm-start", args.warm_start), ("--checkpoint", bool(args.checkpoint)),
                                     ("--metrics", bool(args.metrics)), ("--save-diff-dir", bool(args.save_diff_dir))]
               if on]
    chunked = args.chunk > 1
    if chunked and args.backend not in ("analytic", "ceres"):
        ignored.append("--chunk")
        chunked = False
    if chunked and args.backend == "ceres" and not tr_track_levelmajor_eligible(vo.config, vo.jacobian_mode):
        ignored.append("--chunk (ceres: no level-major tracking for this config)")
        chunked = False
    if ignored:
        print(f"note: {', '.join(ignored)} not supported in keyframe mode (tracking is per-frame against the "
              "current keyframe; the back-end state lives in memory until finalize; chunked tracking needs "
              "--backend analytic or ceres)", file=sys.stderr)

    kvo = KeyframeVisualOdometry(vo, kf_translation=args.kf_translation, kf_rotation=args.kf_rotation,
                                 pg_solver=args.pg_solver, pg_incremental=args.pg_incremental)
    if chunked and hasattr(seq, "height") and getattr(seq, "depth_dtype", np.float32) == np.uint16:
        # the raw replay: frames in their storage dtype (uint16 depth
        # counts), converted once on the device by the tracking dispatch
        def storage_stream():
            while True:
                Ii, Dd, ts = seq.read_chunk(args.chunk, seq.height, seq.width)
                if len(Ii) == 0:
                    return
                for k in range(len(Ii)):
                    yield RGBDFrame(timestamp=float(ts[k]), depth_timestamp=float(ts[k]), intensity=Ii[k],
                                    depth=Dd[k])

        stream = kvo.run_chunked(storage_stream(), chunk=args.chunk, depth_scale=float(seq.depth_scale))
    elif chunked:
        stream = kvo.run_chunked(prefetch(iter(seq)), chunk=args.chunk)
    else:
        stream = kvo.run(prefetch(iter(seq)))
    n = 0
    t0 = time.perf_counter()
    for tf in stream:
        n += 1
        if not args.quiet:
            print(f"frame {tf.frame_index}: kf {tf.keyframe_index}, iters {tf.align_iterations.tolist()}")
        if args.max_frames is not None and n >= args.max_frames:
            break
    t_track = time.perf_counter() - t0
    tracked = kvo.finalize(ba_iterations=args.ba_iterations, ba_window=args.ba_window, ba_grid=args.ba_grid,
                           ba_robust_delta=args.ba_robust_delta, ba_scope=args.ba_scope, ba_covis=args.ba_covis,
                           ba_occ_gate=args.ba_occlusion_gate, ba_z_robust_delta=args.ba_z_robust_delta)
    t_finalize = time.perf_counter() - t0 - t_track
    items = "".join(f", {k} {v:.1f} s" for k, v in kvo.finalize_timings.items())
    print(f"keyframe wall: track {t_track:.1f} s ({n / max(t_track, 1e-9):.1f} frames/s), "
          f"finalize {t_finalize:.1f} s{items}")
    if kvo.incremental_latencies:
        lat = np.asarray(kvo.incremental_latencies)
        print(f"incremental: {len(lat)} solves, per-promotion latency min {lat.min():.3f} s / mean "
              f"{lat.mean():.3f} s / max {lat.max():.3f} s")
    with TrajectoryWriter(args.output) as out:
        for tf in tracked:
            out.write(tf.timestamp, tf.pose)
    if args.export_map:
        if kvo.map_points is None:
            print("note: --export-map needs --ba-iterations > 0 (the map landmarks come from the photometric BA); "
                  "no map written", file=sys.stderr)
        else:
            from phovo_tpu_torch.utils.viz import save_ply

            save_ply(args.export_map, kvo.map_points, kvo.map_intensity)
            print(f"wrote {len(kvo.map_points)} map landmarks to {args.export_map}")
    # one-line run summary, printed even under -q
    print(f"wrote {len(tracked)} poses ({len(kvo.keyframes)} keyframes, {len(kvo.loop_closures)} loop closures) "
          f"to {args.output}")
    _maybe_eval(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
