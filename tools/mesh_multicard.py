#!/usr/bin/env python3
"""The port's mesh forms over NCCL on several cards, each held to the
unsharded call on its own card.

    torchrun --nproc-per-node 4 tools/mesh_multicard.py [--out mesh_multicard.json]
    torchrun --nproc-per-node 4 tools/mesh_multicard.py --device cpu --frames 9 --map-points 2000

(the second: a rehearsal on the CPU over gloo, the kernels' plain
versions, at a small size; it counts no launch and times nothing of a
card)

Every rank makes the same seeded inputs (chip_smoke.py's 257 main-path VGA
frames and 8 serving streams, 8 VGA room keyframes at noisy poses with
their odometry edges, the map-scale reprojection BA problem) and runs
chip_smoke.mesh_forms on its own card unsharded and over the NCCL group
on the mesh shapes (N, 1) and, where N is 4, (2, 2) (the pixel aligner
on (N / 2, 2): VGA's 30-row level takes no 4 ranks): each once to warm up,
then timed in turns (unsharded, each mesh, unsharded; one call each, the
host clock after a synchronize); then phovo-serve --devices N on N raw
streams against one process's files. Bounds: the data axis gives the
unsharded bits, with K-GN launched on every rank; the pixel aligner, the
map-scale BA and finalize's keyframe poses within chip_smoke.MESH_ATOL,
finalize's map the same size. Rank 0 prints each
reading with the cards' names and power limits and writes them as JSON;
the exit code is 1 if any rank misses a bound.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def room_tracker(dev, n_kf=8, seed=3):
    """A back-end tracker on dev holding n_kf VGA room keyframes along the
    forward sweep at noisy poses (1 cm, 5 mrad), with odometry edges
    measured from the truth; and the poses it holds."""
    from phovo_tpu_torch.models.keyframe import Keyframe
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.ops import se3
    from phovo_tpu_torch.utils import config as C
    from phovo_tpu_torch.utils.synthetic import forward_trajectory

    poses_cw = forward_trajectory(6 * n_kf)[::6]
    I, D = cs.render_room_frames(TUM_FR1, cs.SHAPE, poses_cw)
    world = [np.linalg.inv(T) for T in poses_cw]
    rng = np.random.default_rng(seed)
    kvo = cs.backend_tracker(C.load_config(C.builtin_config_dir() / f"{cs.BA_PRESET}.yml"), TUM_FR1, dev)
    for m in range(n_kf):
        noise = np.concatenate([rng.normal(0, 0.01, 3), rng.normal(0, 0.005, 3)]) if m else np.zeros(6)
        pose = world[m] @ se3.pose_matrix_np(noise)
        I8 = np.round(I[m] * 255.0).astype(np.uint8)
        kvo.keyframes.append(Keyframe(index=m, frame_index=6 * m, timestamp=6 * m / 30.0, intensity=I8,
                                      depth=D[m].astype(np.float32), pose=pose, device=dev))
    kvo.odometry_edges = [(m, m + 1, np.linalg.inv(world[m]) @ world[m + 1]) for m in range(n_kf - 1)]
    return kvo, [k.pose.copy() for k in kvo.keyframes]


def step(rank: int, what: str) -> None:
    """A progress line on stderr, so that a rank that stops shows where."""
    print(f"[rank {rank} {time.strftime('%H:%M:%S')}] {what}", file=sys.stderr, flush=True)


def shapes(n: int) -> list:
    """(pixel_parallel of the data-axis forms' mesh, of the pixel aligner's)
    pairs to run: the pixel aligner splits rows over 2 ranks (VGA's 30-row
    level takes no 4)."""
    return [(1, 2), (2, 2)] if n == 4 else [(1, n)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="mesh_multicard.json", help="where rank 0 writes the readings")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--frames", type=int, default=cs.N_FRAMES, help="main-path frames (the dp aligner's pairs + 1)")
    ap.add_argument("--map-points", type=int, default=cs.BA_MAP_SCALE["n_points"],
                    help="landmarks of the map-scale BA problem")
    args = ap.parse_args()
    cs.BA_MAP_SCALE = dict(cs.BA_MAP_SCALE, n_points=args.map_points,
                           obs_per_pose=min(cs.BA_MAP_SCALE["obs_per_pose"], args.map_points))
    if args.frames < cs.N_FRAMES:  # the serving streams within the frames
        cs.SERVE_STREAMS, cs.SERVE_FRAMES = 4, 3

    from phovo_tpu_torch.ops import _build
    from phovo_tpu_torch.ops import fused_batch as fb
    from phovo_tpu_torch.ops.camera import TUM_FR1
    from phovo_tpu_torch.parallel import distributed
    from phovo_tpu_torch.parallel.mesh import Mesh, make_mesh
    from phovo_tpu_torch.utils.synthetic import make_sequence

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("mesh_multicard: torch finds no CUDA card", file=sys.stderr)
        return 1
    distributed.initialize(backend="nccl" if cuda else "gloo")  # from torchrun's environment
    rank, n = dist.get_rank(), dist.get_world_size()
    step(rank, f"process group of {n} ({dist.get_backend()})")
    if cuda:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
        card = subprocess.run(["nvidia-smi", "-i", str(dev.index), "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip()
        if rank == 0:
            _build.build()  # once, before the other ranks load it
        dist.barrier()
        _build.library()
        step(rank, "library loaded")
    else:
        dev, card = torch.device("cpu"), "CPU rehearsal"

    t0 = time.perf_counter()
    I, D, _, ts = make_sequence(TUM_FR1, cs.SHAPE, max(args.frames, 17 + max(2, n)))
    I8 = np.round(np.stack(I) * 255.0).astype(np.uint8)
    D16 = np.round(np.stack(D) / cs.DEPTH_SCALE).astype(np.uint16)
    kvo, snap = room_tracker(dev)
    inputs = cs.mesh_inputs(I8, D16, kvo, snap)
    made = time.perf_counter() - t0
    step(rank, f"inputs made in {made:.1f} s")
    # unsharded on this rank's own card: a mesh of this rank alone, no group, no collective
    alone = Mesh({"data": 1, "pixel": 1}, 0, dev, {})
    meshes = [(make_mesh(n, pixel_parallel=p, devices=[dev] * n), make_mesh(n, pixel_parallel=q, devices=[dev] * n))
              for p, q in shapes(n)]
    # every form once to warm up (first calls, the communicators), then timed in turns:
    # unsharded, each mesh, unsharded; the host clock after a synchronize, one call each
    for data_mesh, pixel_mesh in [(alone, None), *meshes]:
        cs.mesh_forms(inputs, data_mesh, dev, fb, pixel_mesh=pixel_mesh)
    step(rank, "warm-up done")
    ref = cs.mesh_forms(inputs, alone, dev, fb)
    timed = [cs.mesh_forms(inputs, data_mesh, dev, fb, pixel_mesh=pixel_mesh) for data_mesh, pixel_mesh in meshes]
    ref_again = cs.mesh_forms(inputs, alone, dev, fb)
    step(rank, "timed forms done")
    readings, failures = {"ranks": n, "card": card, "inputs_s": made}, []
    for (data_mesh, pixel_mesh), forms in zip(meshes, timed):
        label = f"mesh {data_mesh.shape['data']}x{data_mesh.shape['pixel']}, pixel aligner " \
                f"{pixel_mesh.shape['data']}x{pixel_mesh.shape['pixel']}"
        for name, (res, launches, wall) in forms.items():
            unsharded = ref[name][0]
            row = {"s": wall, "unsharded_s": [ref[name][2], ref_again[name][2]], "K-GN": launches["K-GN"]}
            if name.startswith(("dp aligner", "chunked server")):
                row["bits"] = cs.same_bits(res, unsharded)
                ok = row["bits"] and (launches["K-GN"] > 0 or not cuda)
            elif name == "pixel aligner":
                row["state_diff"] = float(np.abs(res.state - unsharded.state).max())
                ok = row["state_diff"] <= cs.MESH_ATOL and np.array_equal(res.iterations, unsharded.iterations)
            elif name.startswith("finalize"):
                row["pose_diff"] = cs.max_diff(res[:1], unsharded[:1])
                row["map_sizes"] = [len(res[1]), len(unsharded[1])]
                ok = row["pose_diff"] <= cs.MESH_ATOL and len(res[1]) == len(unsharded[1])
            else:
                row["diff"] = cs.max_diff(res[:2], unsharded[:2])
                ok = row["diff"] <= cs.MESH_ATOL
            readings[f"{label}: {name}"] = row
            if not ok:
                failures.append(f"rank {rank} {label}: {name} {row}")

    # phovo-serve over raw streams: one process (rank 0, --devices 1), then
    # every rank (--devices n), into one directory on the host
    work = _build.BUILD_DIR / "mesh_multicard"
    n_streams = max(2, n)
    if rank == 0:
        shutil.rmtree(work, ignore_errors=True)
        for k in range(n_streams):
            cs.write_raw_sequence(work / f"stream{k}", I8[k:k + 17], D16[k:k + 17], ts[k:k + 17], cs.DEPTH_SCALE)
    dist.barrier()
    streams = [work / f"stream{k}" for k in range(n_streams)]
    t0 = time.perf_counter()
    one_rc = cs.mesh_serve(streams, work / "one", 1, dev)
    one_s = time.perf_counter() - t0
    dist.barrier()
    cs.reset_counts(fb)
    t0 = time.perf_counter()
    rc = cs.mesh_serve(streams, work / "all", n, dev)
    cs.sync(dev)
    row = {"streams": n_streams, "devices_s": time.perf_counter() - t0, "K-GN": fb.LAUNCHES}
    dist.barrier()
    if rank == 0:
        row["one_process_s"] = one_s
        row["same_files"] = [cs.pose_lines(work / "all" / f"{d.name}.txt") == cs.pose_lines(work / "one" / f"{d.name}.txt")
                             for d in streams]
        if one_rc or not all(row["same_files"]):
            failures.append(f"phovo-serve: one process exit {one_rc}, same files {row['same_files']}")
        shutil.rmtree(work, ignore_errors=True)
    if rc or not (fb.LAUNCHES or not cuda):
        failures.append(f"rank {rank} phovo-serve --devices {n}: exit {rc}, K-GN {fb.LAUNCHES}")
    readings["phovo-serve"] = row

    step(rank, "phovo-serve done")
    gathered = [None] * n
    dist.all_gather_object(gathered, (readings, failures))
    dist.destroy_process_group()
    if rank == 0:
        for r, (rd, _) in enumerate(gathered):
            print(f"rank {r} [{rd['card']}]: inputs made in {rd['inputs_s']:.1f} s")
            for key, row in rd.items():
                if isinstance(row, dict):
                    print(f"rank {r} {key}: {json.dumps(row)}")
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps([rd for rd, _ in gathered], indent=1))
        bad = [f for _, fs in gathered for f in fs]
        print(json.dumps({"ok": not bad, "ranks": n, "failures": bad}))
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
