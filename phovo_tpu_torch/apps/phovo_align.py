"""CLI: align one RGB-D frame pair (torch port of
phovo_tpu/apps/phovo_align.py; the reference app
PhotoconsistencyFrameAlignment).

    python -m phovo_tpu_torch.apps.phovo_align <config.yml> \
        <source_intensity> <source_depth> <target_intensity> <target_depth> \
        [--backend analytic|ceres|autodiff|biobjective|ic] \
        [--intrinsics default|fr1|fr2|fr3|fx,fy,cx,cy] [--depth-scale 0.001] \
        [--device cuda]

The backend is chosen at run time, by BACKENDS' names. Images are PNGs
(read with cv2, imported only for them: the reference's grayscale and
16-bit depth) or .npy arrays (read with numpy; the way to run on a
machine without cv2). Depth is scaled by --depth-scale (the reference's
1/1000); the default intrinsics are K = [525, 0, 319.5; 0, 525, 239.5].
The pair runs on --device, the CUDA card unless the caller names
another. --save-diff and --save-diff-dir (the difference images) wait for
the visualisation utilities, ROADMAP.md queue A, item 12, and raise
NotImplementedError.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from phovo_tpu_torch.apps._common import add_device_argument, intrinsic_matrix, resolve_device

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
                   help="write |target - warped source| here: not ported yet (ROADMAP.md queue A, item 12); raises")
    p.add_argument("--mix-mode", default=None, choices=["f32", "bf16x2g", "bf16x2", "bf16"],
                   help="accepted and without effect: the port computes in float32")
    p.add_argument("--save-diff-dir", default=None,
                   help="per-iteration diff images: not ported yet (ROADMAP.md queue A, item 12); raises")
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
    for flag, value in (("--save-diff", args.save_diff), ("--save-diff-dir", args.save_diff_dir)):
        if value:
            raise NotImplementedError(
                f"{flag}: the difference images are not ported yet (ROADMAP.md queue A, item 12)"
            )
    device = resolve_device(args.device)

    from phovo_tpu_torch.models import BACKENDS
    from phovo_tpu_torch.utils.config import load_config, override_config

    cfg = override_config(load_config(args.config), mix_mode=args.mix_mode)
    intr = parse_intrinsics(args.intrinsics)
    src_i, tgt_i = read_image(args.source_intensity, False), read_image(args.target_intensity, False)
    src_d = read_image(args.source_depth, True).astype(np.float32) * args.depth_scale
    tgt_d = read_image(args.target_depth, True).astype(np.float32) * args.depth_scale

    vo = BACKENDS[args.backend](cfg, device=device)
    vo.set_intrinsic_matrix(intrinsic_matrix(intr))
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
