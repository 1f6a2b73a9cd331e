"""CLI: multi-camera visual odometry serving: S RGB-D streams, one
dispatch a round (torch port of phovo_tpu/apps/phovo_serve.py).

    python -m phovo_tpu_torch.apps.phovo_serve --config cfg.yml \
        --dataset seqA --dataset seqB [...] --out-dir out/ \
        [--chunk 16] [--intrinsics fr1] [--warm-start] [--device cuda]
    torchrun --nproc-per-node N -m phovo_tpu_torch.apps.phovo_serve \
        --devices N --dataset ... --out-dir out/

Every round a chunk of --chunk frames from EACH stream is aligned in one
call of parallel/batch.py::serve_sequences_chunk: the streams' zero-init
pairs form one level-major batch, one K-GN launch a level, each stream's
carry frame stays on the device; --chunk 1 serves live cameras, one new
frame and one pair a stream a round, K-GN at B = the stream count. The
host advances each stream's global pose from the chunk's states (pose <-
pose @ Rt^-1, float64, as phovo-vo --chunk does), so a served stream
writes its own phovo-vo --chunk trajectory, and writes one TUM-format
trajectory per stream (<out-dir>/<stream name>.txt). Streams may differ
in length: an exhausted or short chunk is padded by repeating the
stream's last frame, and the padding pairs' poses are dropped.

Several cards (--devices, phovo_tpu's rule): the streams are split over
the data axis of a mesh of N ranks (parallel/mesh.py); 'auto' takes the
largest divisor of S that is at most the world size (torchrun's ranks, 1
without it), and an N that does not divide S exits 1. Each rank opens only
its share of the streams (distributed.local_batch_slice), serves them on
its own card and writes their trajectories: the ranks exchange nothing,
and each file is a one-card run's file, since a stream's result does not
depend on the streams beside it. An N above the world size raises
ValueError (exit 1); a rank past the mesh serves nothing.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

from phovo_tpu_torch.apps._common import add_device_argument, resolve_device, to_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="phovo-serve", description="Multi-camera photoconsistency VO serving (TUM RGB-D)")
    p.add_argument("--config", "-c", required=True)
    p.add_argument("--dataset", "-d", action="append", required=True,
                   help="TUM sequence dir (or phovo-convert raw dir); repeat once per camera stream")
    p.add_argument("--out-dir", "-o", required=True, help="one <stream-name>.txt trajectory per stream")
    p.add_argument("--intrinsics", default="fr1",
                   help="named preset (default/fr1/fr2/fr3) or 'fx,fy,cx,cy' (shared by all streams)")
    p.add_argument("--depth-scale", type=float, default=1.0 / 5000.0)
    p.add_argument("--pairing", default="associate", choices=["associate", "lockstep"])
    p.add_argument("--chunk", type=int, default=16,
                   help="frames ingested per stream per dispatch (1: one new frame a camera a round)")
    p.add_argument("--devices", default="auto",
                   help="cards to serve on (the data axis): 'auto' (the largest divisor of the stream count up to "
                        "the world size) or N, dividing the stream count, at most the world size (torchrun's ranks)")
    p.add_argument("--warm-start", action="store_true")
    p.add_argument("--max-frames", type=int, default=None, help="cap on aligned pairs per stream")
    p.add_argument("--mix-mode", default=None, choices=["f32", "bf16x2g", "bf16x2", "bf16"],
                   help="accepted and without effect: the port computes in float32")
    p.add_argument("--quiet", "-q", action="store_true")
    add_device_argument(p)
    return p


def _open_stream(path: str, depth_scale: float, pairing: str):
    from phovo_tpu_torch.datasets import raw as raw_ds
    from phovo_tpu_torch.datasets.tum import TUMSequence

    if raw_ds.is_raw_dir(path):
        return raw_ds.RawSequence(path)
    return TUMSequence(path, depth_scale=depth_scale, pairing=pairing)


def _stream_names(paths: list[str]) -> list[str]:
    """Basenames, a repeated one prefixed with its stream index."""
    names = [Path(p).name or Path(p).resolve().name for p in paths]
    return [f"{i}_{n}" if names.count(n) > 1 else n for i, n in enumerate(names)]


def main(argv=None) -> int:
    try:
        return _main(argv)
    except (FileNotFoundError, ValueError, IOError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _main(argv=None) -> int:
    from phovo_tpu_torch.parallel import distributed

    args = build_parser().parse_args(argv)
    created = distributed.initialize()
    try:
        return _serve(args)
    finally:
        if created:
            import torch.distributed as dist

            dist.destroy_process_group()


def _serve(args) -> int:
    device = resolve_device(args.device)

    from phovo_tpu_torch.apps.phovo_align import parse_intrinsics
    from phovo_tpu_torch.datasets.tum import prefetch
    from phovo_tpu_torch.ops import se3
    from phovo_tpu_torch.parallel.batch import serve_sequences_chunk
    from phovo_tpu_torch.parallel.distributed import local_batch_slice
    from phovo_tpu_torch.parallel.mesh import make_mesh, world
    from phovo_tpu_torch.utils.config import load_config, override_config
    from phovo_tpu_torch.utils.trajectory import TrajectoryWriter

    cfg = override_config(load_config(args.config), mix_mode=args.mix_mode)
    intr = parse_intrinsics(args.intrinsics)
    if args.devices == "auto":
        n_world = world()[0]
        n_data = max(k for k in range(1, min(len(args.dataset), n_world) + 1) if len(args.dataset) % k == 0)
    else:
        n_data = int(args.devices)
        if n_data < 1:
            print(f"error: --devices {n_data}: at least 1", file=sys.stderr)
            return 1
        if len(args.dataset) % n_data != 0:
            print(f"error: {len(args.dataset)} streams not divisible by --devices {n_data}", file=sys.stderr)
            return 1
    mesh = make_mesh(n_data, pixel_parallel=1)
    if device.type == "cuda" and device.index is None:  # each rank its own card
        device = mesh.device
    lo, S = local_batch_slice(len(args.dataset), mesh)
    if S == 0:  # a rank past the mesh
        return 0
    datasets = args.dataset[lo:lo + S]
    seqs = [_open_stream(d, args.depth_scale, args.pairing) for d in datasets]
    for d, s in zip(datasets, seqs):
        if len(s) < 2:
            print(f"error: fewer than 2 paired frames in {d}", file=sys.stderr)
            return 1
    streams = [prefetch(iter(s)) for s in seqs]
    names = _stream_names(args.dataset)[lo:lo + S]
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    # the first frame of each stream is its carry
    first = [next(st, None) for st in streams]
    if any(f is None for f in first):
        print("error: empty stream", file=sys.stderr)
        return 1
    shapes = {f.intensity.shape for f in first}
    if len(shapes) != 1:
        print(f"error: streams disagree on frame size: {shapes}", file=sys.stderr)
        return 1
    carry_i = to_device(np.stack([np.asarray(f.intensity) for f in first]), device)
    carry_d = to_device(np.stack([np.asarray(f.depth, np.float32) for f in first]), device)
    last = [(np.asarray(f.intensity), np.asarray(f.depth, np.float32)) for f in first]
    poses = [np.eye(4) for _ in range(S)]
    n_taken = [0] * S  # pairs ingested per stream
    B = args.chunk

    def next_chunk(s: int):
        """(I (B, H, W), D, timestamps, real frames): padded to B frames."""
        Ii, Dd, ts = [], [], []
        for fr in streams[s]:
            Ii.append(np.asarray(fr.intensity))
            Dd.append(np.asarray(fr.depth, np.float32))
            ts.append(fr.timestamp)
            if len(Ii) >= B or (args.max_frames is not None and n_taken[s] + len(Ii) >= args.max_frames):
                break
        m = len(Ii)
        n_taken[s] += m
        if m:
            last[s] = (Ii[-1], Dd[-1])
        while len(Ii) < B:
            Ii.append(last[s][0])
            Dd.append(last[s][1])
        return np.stack(Ii), np.stack(Dd), ts, m

    writers = [TrajectoryWriter(out_dir / f"{n}.txt") for n in names]
    pending = None  # (device states (S, B, 6), per-stream timestamps, dispatch time)
    t_start = time.perf_counter()
    total_pairs = 0

    def flush(p) -> None:
        nonlocal total_pairs
        states, ts_all, t0 = p
        states = states.cpu().numpy()
        dt = time.perf_counter() - t0
        m_round = 0
        for s in range(S):
            for k, t in enumerate(ts_all[s]):
                poses[s] = poses[s] @ np.linalg.inv(se3.pose_matrix_np(states[s, k]))
                writers[s].write(t, poses[s])
            m_round += len(ts_all[s])
        total_pairs += m_round
        if not args.quiet and m_round:
            print(f"round: {m_round} pairs in {dt:.4f} s ({m_round / dt:.1f} pairs/s)")

    try:
        while not (args.max_frames is not None and all(n >= args.max_frames for n in n_taken)):
            chunks = [next_chunk(s) for s in range(S)]
            if all(c[3] == 0 for c in chunks):
                break
            t0 = time.perf_counter()
            res, _, carry_i, carry_d = serve_sequences_chunk(
                carry_i, carry_d, to_device(np.stack([c[0] for c in chunks]), device),
                to_device(np.stack([c[1] for c in chunks]), device), intr, cfg, warm_start=args.warm_start,
            )
            if pending is not None:
                flush(pending)
            pending = (res.state, [c[2] for c in chunks], t0)
    finally:
        if pending is not None:
            flush(pending)
        for w in writers:
            w.close()
    if not args.quiet:
        dt = time.perf_counter() - t_start
        print(f"served {S} streams, {total_pairs} pairs in {dt:.2f} s ({total_pairs / max(dt, 1e-9):.1f} pairs/s "
              f"aggregate); trajectories in {out_dir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
