"""Build and load the port's CUDA kernels.

Every `*.cu` file under phovo_tpu_torch/csrc/ is compiled by its own nvcc
process, all of them at once, for sm_90a (Hopper), and the objects are
linked into ONE shared library with a plain C interface, loaded with
ctypes; the `*.cuh` headers beside them hold device code the sources
share. The library lands in build/phovo_tpu_torch/ at the repository root,
named by a hash of the sources, the headers and the flags, so an unchanged
tree builds once and a changed one never loads a stale library. The build
runs at first use, never at import; a missing nvcc or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "phovo_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
    # no contracted multiply-adds, and IEEE division and square root (nvcc's
    # defaults, stated): the kernels then round every product, quotient,
    # root and sum like the plain torch versions they are checked against
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: (argtypes, restype); every entry returns cudaGetLastError()
_ENTRIES = {
    "phovo_fused_gn_level_batch": (
        [_P] * 8 + [_I] * 8 + [_F] * 4 + [_I, _F, _F, _I, _P],
        _I,
    ),
    "phovo_fused_tr_level_batch": (
        [_P] * 6 + [_I] * 7 + [_F] * 5 + [_I] + [_F] * 7 + [_P],
        _I,
    ),
    "phovo_fused_lin": (
        [_P] * 6 + [_I, _P] + [_I] * 7 + [_F] * 4 + [_P],
        _I,
    ),
    "phovo_ic_precompute": (
        [_P] * 6 + [_I] * 4 + [_F] * 6 + [_P],
        _I,
    ),
    "phovo_ic_gn_level_batch": (
        [_P] * 7 + [_I] * 6 + [_F] * 4 + [_I, _F, _F, _P],
        _I,
    ),
    "phovo_prep_levels": (
        [_P] * 4 + [_I] * 3 + [_F] + [_I] * 8 + [_F] * 2 + [_I] + [_P] * 6,
        _I,
    ),
}


_C_SCALARS = {"int": _I, "float": _F}


def entry_signatures(source: str) -> dict[str, list[tuple[str, type]]]:
    """The `extern "C" int name(...)` entry points of a CUDA source, each as
    its parameters in order: (name, ctypes type), every pointer a
    c_void_p."""
    entries = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', source):
        entries[name] = []
        for param in params.split(","):
            *words, arg = param.replace("*", " * ").split()
            scalar = " ".join(w for w in words if w != "const")
            entries[name].append((arg, _P if "*" in words else _C_SCALARS[scalar]))
    return entries


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin/nvcc (CUDA_HOME defaults to the
    toolkit's standard /usr/local/cuda), else the first nvcc on PATH."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    found = home / "bin" / "nvcc"
    if found.is_file():
        return str(found)
    on_path = shutil.which("nvcc")
    if on_path is None:
        raise RuntimeError(
            f"nvcc not found (looked in {home / 'bin'} and on PATH): the "
            "CUDA kernels cannot be built"
        )
    return on_path


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    """Where the library for the current sources, headers and flags
    lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*_sources(), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libphovo_tpu_torch_{h.hexdigest()[:16]}.so"


def _run(cmd: list[str]) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )


def build() -> Path:
    """Compile the sources unless the library for them exists; returns its
    path. Each source compiles in its own nvcc process, all started
    together (the five sources before K-PREP's: 14-17 s on an 8-core H100
    host, where three took ~31 s in one nvcc); then one nvcc links the
    objects. Writes to temporary names first, so a cut build leaves no
    library behind."""
    so = library_path()
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    exe = nvcc()
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in _sources()]
    compiles = [
        [exe, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
        for src, obj in zip(_sources(), objs)
    ]
    try:
        # every compile runs to its end (pool.map would cancel the ones not
        # yet started once one fails); then the first failure raises
        with ThreadPoolExecutor(len(compiles)) as pool:
            futures = [pool.submit(_run, cmd) for cmd in compiles]
        for future in futures:
            future.result()
        _run([exe, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)])
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process, with every entry
    point's argument and result types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
