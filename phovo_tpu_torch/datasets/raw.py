"""The raw memory-mapped sequence format (torch port of
phovo_tpu/datasets/raw.py, the same files): a TUM PNG sequence decoded
once by convert_to_raw into flat arrays that RawSequence streams without
decoding,

    <out>/meta.json                  {"format_version": 2, "n", "height", "width",
                                      "depth_scale", "pairing", "source"}
    <out>/intensity.u8.npy           (n, H, W) uint8, C order
    <out>/depth.u16.npy              (n, H, W) uint16 counts (x depth_scale = m)
    <out>/timestamps.f64.npy         (n,) float64
    <out>/depth_timestamps.f64.npy   (n,) float64

The uint8 intensity and uint16 depth go to the card in their storage
dtypes and are converted there (ops/prep.py::chunk_device_prep). This
is how recorded frames reach the machine with the card, which has no cv2:
convert where cv2 or the libpng loader runs, copy the directory, replay.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator

import numpy as np

from phovo_tpu_torch.datasets.tum import RGBDFrame, TUM_DEPTH_SCALE

META_NAME = "meta.json"
FORMAT_VERSION = 2


def is_raw_dir(path: str | Path) -> bool:
    return (Path(path) / META_NAME).is_file()


def convert_to_raw(
    dataset_dir: str | Path,
    out_dir: str | Path,
    depth_scale: float = TUM_DEPTH_SCALE,
    pairing: str = "associate",
    loader: str = "auto",
    max_frames: int | None = None,
) -> Path:
    """Decode a TUM PNG sequence into the raw memmap layout; returns
    out_dir. loader 'native' decodes with the repository's libpng loader
    (datasets/native_loader.py) and raises where it is not built,
    'python' with cv2 (datasets/tum.py), 'auto' with the libpng loader
    where it loads, else cv2."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    from phovo_tpu_torch.datasets import native_loader

    use_native = loader == "native" or (loader == "auto" and native_loader.available())
    if use_native and not native_loader.available():
        raise IOError(
            "native loader requested but native/libphovo_io.so is not built"
        )
    if use_native:
        seq = native_loader.NativeTUMSequence(
            dataset_dir, depth_scale=depth_scale, pairing=pairing
        )
    else:
        from phovo_tpu_torch.datasets.tum import TUMSequence

        seq = TUMSequence(dataset_dir, depth_scale=depth_scale, pairing=pairing)

    n_total = len(seq)
    if max_frames is not None:
        n_total = min(n_total, max_frames)
    if n_total == 0:
        raise ValueError(f"no paired frames found in {dataset_dir}")

    it = iter(seq)
    first = next(it)
    H, W = first.intensity.shape

    i_mm = np.lib.format.open_memmap(
        out / "intensity.u8.npy", mode="w+", dtype=np.uint8, shape=(n_total, H, W)
    )
    d_mm = np.lib.format.open_memmap(
        out / "depth.u16.npy", mode="w+", dtype=np.uint16, shape=(n_total, H, W)
    )
    ts = np.empty(n_total, dtype=np.float64)
    ts_d = np.empty(n_total, dtype=np.float64)

    def store(k: int, fr: RGBDFrame) -> None:
        inten = np.asarray(fr.intensity)
        if inten.dtype != np.uint8:
            inten = np.clip(inten * 255.0 + 0.5, 0, 255).astype(np.uint8)
        i_mm[k] = inten
        # frames carry metric float depth; counts = depth / scale recovers
        # the original PNG u16 exactly (they were produced as count * scale)
        d_mm[k] = np.clip(
            np.asarray(fr.depth, np.float64) / depth_scale + 0.5, 0, 65535
        ).astype(np.uint16)
        ts[k] = fr.timestamp
        ts_d[k] = getattr(fr, "depth_timestamp", fr.timestamp)

    store(0, first)
    n = 1
    for fr in it:
        if n >= n_total:
            break
        store(n, fr)
        n += 1
    i_mm.flush()
    d_mm.flush()
    np.save(out / "timestamps.f64.npy", ts[:n])
    np.save(out / "depth_timestamps.f64.npy", ts_d[:n])

    meta = {
        "format_version": FORMAT_VERSION,
        "n": int(n),
        "height": int(H),
        "width": int(W),
        "depth_scale": float(depth_scale),
        "pairing": pairing,
        "source": str(dataset_dir),
    }
    (out / META_NAME).write_text(json.dumps(meta, indent=2) + "\n")
    return out


class RawSequence:
    """Zero-decode streaming over a raw-converted sequence directory:
    len(), iteration yielding RGBDFrame (uint8 intensity, float32 metric
    depth), and read_chunk for the chunked pipeline, as
    NativeTUMSequence."""

    def __init__(self, path: str | Path):
        self.root = Path(path)
        meta_file = self.root / META_NAME
        if not meta_file.is_file():
            raise FileNotFoundError(
                f"{meta_file} not found — convert with phovo-convert first"
            )
        self.meta = json.loads(meta_file.read_text())
        version = self.meta.get("format_version")
        if version != FORMAT_VERSION:
            raise ValueError(f"unsupported raw format version {version}; convert again with phovo-convert")
        self._n = int(self.meta["n"])
        self.height = int(self.meta["height"])
        self.width = int(self.meta["width"])
        self.depth_scale = float(self.meta["depth_scale"])
        self._intensity = np.load(self.root / "intensity.u8.npy", mmap_mode="r")
        self._depth = np.load(self.root / "depth.u16.npy", mmap_mode="r")
        self.depth_dtype = np.uint16
        self._timestamps = np.load(self.root / "timestamps.f64.npy")
        dts = self.root / "depth_timestamps.f64.npy"
        self._depth_timestamps = (
            np.load(dts) if dts.is_file() else self._timestamps
        )
        self._cursor = 0

    def __len__(self) -> int:
        return self._n

    def __iter__(self) -> Iterator[RGBDFrame]:
        # restartable, random-access iteration (the native loader streams
        # once); the chunk cursor below is separate: the chunked pipeline
        # primes with read_chunk(1), never by iterating
        for k in range(self._n):
            # frame mode wants metric float32 depth
            depth = self._depth[k].astype(np.float32) * np.float32(self.depth_scale)
            yield RGBDFrame(
                timestamp=float(self._timestamps[k]),
                depth_timestamp=float(self._depth_timestamps[k]),
                intensity=self._intensity[k],
                depth=depth,
            )

    def read_chunk(self, n: int, H: int, W: int):
        """Next up-to-n frames as contiguous (m,H,W) slices (m==0 at end).

        Returns views of the memmaps in their storage dtype (uint8
        intensity, uint16 depth counts): the chunked entries copy them to
        the card as they are and convert them there; callers scale the
        depth by self.depth_scale."""
        if (H, W) != (self.height, self.width):
            raise IOError(
                f"sequence is {self.height}x{self.width}, expected {H}x{W}"
            )
        k0 = self._cursor
        k1 = min(k0 + n, self._n)
        self._cursor = k1
        return (
            self._intensity[k0:k1],
            self._depth[k0:k1],
            self._timestamps[k0:k1],
        )

    def close(self) -> None:
        pass
