"""ctypes bindings for the repository's decode-ahead TUM loader
(native/phovo_io.cpp built into native/libphovo_io.so; torch port of
phovo_tpu/datasets/native_loader.py, the same library and calls).

NativeTUMSequence does what datasets/tum.py's TUMSequence and prefetch do,
but decodes the PNGs with libpng in a C++ worker pool with an in-order
reorder buffer, and needs no cv2. available() is False where the library
is not built (`make -C native`) or does not load; callers report that.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

from phovo_tpu_torch.datasets.tum import RGBDFrame, TUM_DEPTH_SCALE

# the repository's library (native/Makefile builds it); nothing here builds it
_LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libphovo_io.so"


@functools.cache
def _load() -> ctypes.CDLL:
    """The loaded library with its entry points typed, once per process;
    OSError where it does not load."""
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.phovo_loader_open.restype = ctypes.c_void_p
    lib.phovo_loader_open.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_double, ctypes.c_int,
        ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.phovo_loader_len.restype = ctypes.c_int
    lib.phovo_loader_len.argtypes = [ctypes.c_void_p]
    lib.phovo_loader_next.restype = ctypes.c_int
    lib.phovo_loader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.phovo_loader_close.restype = None
    lib.phovo_loader_close.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "phovo_loader_stop"):
        lib.phovo_loader_stop.restype = None
        lib.phovo_loader_stop.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """Whether native/libphovo_io.so is built and loads."""
    if not _LIB_PATH.is_file():
        return False
    try:
        _load()
        return True
    except OSError:
        return False


MAX_PIXELS = 4096 * 3072  # capacity bound for the transfer buffers


class NativeTUMSequence:
    """Iterable of RGBDFrame backed by the native decode-ahead pipeline."""

    def __init__(
        self,
        root: str | Path,
        rgb_index: str = "rgb.txt",
        depth_index: str = "depth.txt",
        depth_scale: float = TUM_DEPTH_SCALE,
        pairing: str = "associate",
        max_dt: float = 0.02,
        prefetch: int = 4,
        threads: int = 2,
    ):
        self._lib = _load()
        root = Path(root)
        err = ctypes.create_string_buffer(512)
        self._handle = self._lib.phovo_loader_open(
            str(root / rgb_index).encode(),
            str(root / depth_index).encode(),
            depth_scale,
            1 if pairing == "lockstep" else 0,
            max_dt,
            prefetch,
            threads,
            err,
            len(err),
        )
        if not self._handle:
            raise FileNotFoundError(err.value.decode() or "native loader open failed")
        self._len = self._lib.phovo_loader_len(self._handle)
        self._closed = False
        # close() may run (at exit, on the main thread) while a prefetch
        # thread is inside phovo_loader_next: the native stop() wakes a
        # waiting consumer, and this lock keeps the handle alive until the
        # consumer has left next()
        self._lock = threading.Lock()
        # the native worker threads must be joined before the interpreter
        # tears down (a live std::thread at exit calls std::terminate), and
        # __del__ may run too late for that
        atexit.register(self.close)

    def __len__(self) -> int:
        return self._len

    def __iter__(self) -> Iterator[RGBDFrame]:
        intensity = np.empty(MAX_PIXELS, dtype=np.uint8)
        depth = np.empty(MAX_PIXELS, dtype=np.float32)
        ts_r = ctypes.c_double()
        ts_d = ctypes.c_double()
        H = ctypes.c_int()
        W = ctypes.c_int()
        err = ctypes.create_string_buffer(512)
        while True:
            with self._lock:
                if self._closed:
                    return
                rc = self._lib.phovo_loader_next(
                    self._handle,
                    intensity.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    MAX_PIXELS,
                    ctypes.byref(ts_r), ctypes.byref(ts_d),
                    ctypes.byref(H), ctypes.byref(W),
                    err, len(err),
                )
            if rc == 1:
                return
            if rc != 0:
                raise IOError(err.value.decode() or "native decode failed")
            h, w = H.value, W.value
            yield RGBDFrame(
                timestamp=ts_r.value,
                depth_timestamp=ts_d.value,
                intensity=intensity[: h * w].reshape(h, w).copy(),
                depth=depth[: h * w].reshape(h, w).copy(),
            )

    def read_chunk(self, n: int, H: int, W: int):
        """Decode up to n frames directly into contiguous chunk buffers.

        Returns (intensity (m, H, W) uint8, depth (m, H, W) float32,
        timestamps (m,)) with m <= n (m == 0 at the end of the stream). The
        C++ workers copy into the numpy buffers: no per-frame copy or stack
        in Python."""
        intensity = np.empty((n, H, W), dtype=np.uint8)
        depth = np.empty((n, H, W), dtype=np.float32)
        ts = np.empty(n, dtype=np.float64)
        ts_r = ctypes.c_double()
        ts_d = ctypes.c_double()
        Ho = ctypes.c_int()
        Wo = ctypes.c_int()
        err = ctypes.create_string_buffer(512)
        m = 0
        for k in range(n):
            with self._lock:
                if self._closed:
                    break
                rc = self._lib.phovo_loader_next(
                    self._handle,
                    intensity[k].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    depth[k].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    H * W,
                    ctypes.byref(ts_r), ctypes.byref(ts_d),
                    ctypes.byref(Ho), ctypes.byref(Wo),
                    err, len(err),
                )
            if rc == 1:
                break
            if rc != 0:
                raise IOError(err.value.decode() or "native decode failed")
            if (Ho.value, Wo.value) != (H, W):
                raise IOError(
                    f"frame {k} is {Ho.value}x{Wo.value}, expected {H}x{W}"
                )
            ts[m] = ts_r.value
            m += 1
        return intensity[:m], depth[:m], ts[:m]

    def close(self) -> None:
        if self._closed or not self._handle:
            return
        # wake a consumer blocked inside phovo_loader_next first, without
        # the lock (the consumer holds it): it sees the end of the stream
        # and lets the lock go, and then the handle can be destroyed
        if hasattr(self._lib, "phovo_loader_stop"):
            self._lib.phovo_loader_stop(self._handle)
        with self._lock:
            if not self._closed:
                self._lib.phovo_loader_close(self._handle)
                self._closed = True

    def __del__(self):
        # best effort at garbage collection; close() at exit is the sure one
        try:
            self.close()
        except Exception:
            pass
