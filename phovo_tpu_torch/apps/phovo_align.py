"""CLI: align one RGB-D frame pair (torch port of
phovo_tpu/apps/phovo_align.py; the reference app
PhotoconsistencyFrameAlignment).

    python -m phovo_tpu_torch.apps.phovo_align <config.yml> \
        <source_intensity> <source_depth> <target_intensity> <target_depth> \
        [--backend analytic|ceres|autodiff|biobjective|ic] \
        [--intrinsics default|fr1|fr2|fr3|fx,fy,cx,cy] [--depth-scale 0.001] \
        [--save-diff diff.png] [--save-diff-dir DIR] [--device cuda]

The backend is chosen at run time, by BACKENDS' names. Images are PNGs
(read with cv2, imported only for them: the reference's grayscale and
16-bit depth) or .npy arrays (read with numpy; the way to run on a
machine without cv2). Depth is scaled by --depth-scale (the reference's
1/1000); the default intrinsics are K = [525, 0, 319.5; 0, 525, 239.5].
The pair runs on --device, the CUDA card unless the caller names
another. --save-diff writes |target - forward-warped source| at the
result as an 8-bit PNG (the reference's imshow check); --save-diff-dir,
with visualizeIterations (visualize_iterations) true in the config and
the analytic or biobjective backend, replays the alignment iteration by
iteration (utils/trace.py) and writes one difference PNG an iteration.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from phovo_tpu_torch.apps._common import add_device_argument, resolve_device

BACKEND_NAMES = ["analytic", "ceres", "autodiff", "biobjective", "ic"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="phovo-align", description="Photoconsistency RGB-D frame alignment")
    p.add_argument("config", help="YAML config (native or reference schema)")
    p.add_argument("source_intensity")
    p.add_argument("source_depth")
    p.add_argument("target_intensity")
    p.add_argument("target_depth")
    p.add_argument("--backend", default="analytic", choices=BACKEND_NAMES)
    p.add_argument("--intrinsics", default="default", help="named preset (default/fr1/fr2/fr3) or 'fx,fy,cx,cy'")
    p.add_argument("--depth-scale", type=float, default=1.0 / 1000.0,
                   help="meters per depth image unit (reference: 1/1000)")
    p.add_argument("--save-diff", default=None,
                   help="write the |target - warped source| image here (the reference's imshow check)")
    p.add_argument("--mix-mode", default=None, choices=["f32", "bf16x2g", "bf16x2", "bf16"],
                   help="accepted and without effect: the port computes in float32")
    p.add_argument("--save-diff-dir", default=None,
                   help="with visualizeIterations: true in the config, write a per-iteration diff PNG into this "
                        "directory (the reference's per-iteration imshow)")
    add_device_argument(p)
    return p


def parse_intrinsics(spec: str):
    """A named preset (default, fr1, fr2, fr3) or 'fx,fy,cx,cy', rounded to
    float32 as the kernels compute."""
    from phovo_tpu_torch.ops.camera import NAMED_INTRINSICS, Intrinsics

    if spec in NAMED_INTRINSICS:
        return NAMED_INTRINSICS[spec]
    vals = [float(v) for v in spec.split(",")]
    if len(vals) != 4:
        raise ValueError("intrinsics must be a preset name or fx,fy,cx,cy")
    return Intrinsics(*(float(np.float32(v)) for v in vals))


def read_image(path: str, depth: bool) -> np.ndarray:
    """A .npy array, or a PNG read by cv2: grayscale uint8 intensity, depth
    unchanged (16-bit counts)."""
    if path.endswith(".npy"):
        return np.load(path)
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED if depth else cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise IOError(f"cannot read image {path}")
    return img


def main(argv=None) -> int:
    try:
        return _main(argv)
    except (FileNotFoundError, ValueError, IOError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    from phovo_tpu_torch.models import BACKENDS
    from phovo_tpu_torch.utils.config import load_config, override_config

    cfg = override_config(load_config(args.config), mix_mode=args.mix_mode)
    intr = parse_intrinsics(args.intrinsics)
    src_i, tgt_i = read_image(args.source_intensity, False), read_image(args.target_intensity, False)
    src_d = read_image(args.source_depth, True).astype(np.float32) * args.depth_scale
    tgt_d = read_image(args.target_depth, True).astype(np.float32) * args.depth_scale

    vo = BACKENDS[args.backend](cfg, device=device)
    vo.set_intrinsic_matrix(intr.matrix())
    vo.set_source_frame(src_i, src_d)
    vo.set_target_frame(tgt_i, tgt_d)
    vo.set_initial_state_vector(np.zeros(6, np.float32))

    t0 = time.perf_counter()
    result = vo.optimize()
    state = result.state.cpu().numpy()
    print(f"Time = {time.perf_counter() - t0} sec.")
    print("state vector (x y z yaw pitch roll):")
    print(state)
    print("Rt:")
    print(vo.get_optimal_rigid_transformation_matrix().cpu().numpy())
    print("per-level iterations:", result.iterations.cpu().numpy())
    _save_diffs(args, cfg, intr, device, state, src_i, src_d, tgt_i, tgt_d)
    return 0


def _save_diffs(args, cfg, intr, device, state, src_i, src_d, tgt_i, tgt_d) -> None:
    """--save-diff-dir's per-iteration images and --save-diff's image at
    the result, as phovo_tpu's app writes them."""
    from phovo_tpu_torch.utils.viz import alignment_diff, save_image

    if args.save_diff_dir and cfg.visualize_iterations:
        if args.backend in ("analytic", "biobjective"):
            from phovo_tpu_torch.utils.trace import save_iteration_diffs, trace_alignment

            records = trace_alignment(src_i, src_d, tgt_i, tgt_d, intr, cfg, backend=args.backend, device=device)
            paths = save_iteration_diffs(records, src_i, src_d, tgt_i, intr, args.save_diff_dir, device=device)
            print(f"wrote {len(paths)} per-iteration diff images to {args.save_diff_dir}")
        else:
            print(f"note: per-iteration trace not supported for backend {args.backend!r}; see per-level "
                  "diagnostics above", file=sys.stderr)
    elif args.save_diff_dir:
        print("note: --save-diff-dir needs visualizeIterations: true (or visualize_iterations: true) in the config",
              file=sys.stderr)
    if args.save_diff:
        diff = alignment_diff(src_i, src_d, tgt_i, state, intr, device=device)
        save_image(args.save_diff, diff.astype(np.uint8))
        print(f"wrote difference image to {args.save_diff}")


if __name__ == "__main__":
    sys.exit(main())
