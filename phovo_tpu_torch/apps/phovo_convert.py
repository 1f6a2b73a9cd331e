"""CLI: convert a TUM PNG sequence into the raw memmap replay format
(torch port of phovo_tpu/apps/phovo_convert.py, the same files).

    python -m phovo_tpu_torch.apps.phovo_convert --dataset /data/fr1_desk \
        --out /data/fr1_desk/phovo_raw [--depth-scale 0.0002] \
        [--pairing associate|lockstep] [--loader auto|native|python] \
        [--max-frames N]

Decoding needs cv2 (--loader python) or the repository's libpng loader,
native/libphovo_io.so (--loader native); 'auto' takes the libpng loader
where it loads. The output directory is a --dataset for phovo-vo and
phovo-serve (found by its meta.json), which replay it without decoding:
the way recorded frames reach a machine without cv2. The conversion runs
on the host and needs no card, so it takes no --device.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="phovo-convert", description="Convert a TUM RGB-D sequence to the raw memmap format")
    p.add_argument("--dataset", "-d", required=True, help="TUM sequence dir containing rgb.txt/depth.txt")
    p.add_argument("--out", "-o", required=True, help="output directory")
    p.add_argument("--depth-scale", type=float, default=1.0 / 5000.0)
    p.add_argument("--pairing", default="associate", choices=["associate", "lockstep"])
    p.add_argument("--loader", default="auto", choices=["auto", "native", "python"])
    p.add_argument("--max-frames", type=int, default=None)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from phovo_tpu_torch.datasets.raw import RawSequence, convert_to_raw

    try:
        t0 = time.perf_counter()
        out = convert_to_raw(args.dataset, args.out, depth_scale=args.depth_scale, pairing=args.pairing,
                             loader=args.loader, max_frames=args.max_frames)
        seq = RawSequence(out)
        dt = time.perf_counter() - t0
    except (FileNotFoundError, ValueError, IOError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"converted {len(seq)} frames ({seq.height}x{seq.width}) to {out} in {dt:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
