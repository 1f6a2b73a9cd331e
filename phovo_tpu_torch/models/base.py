"""Backend-independent alignment API (torch port of
phovo_tpu/models/base.py): results, input conversion, the serial pair loop
and the reference's object interface (CPhotoconsistencyOdometry.h:137-179).

The object API is a thin host-side holder of frames over a backend's
functional `align`; it runs on the CUDA card unless the caller names
another device (device="cpu"), and raises where there is no card rather
than run elsewhere. The functional entries run wherever their tensors
live. phovo_tpu's
band-fallback re-run has no counterpart: the GPU kernels sample the whole
target, so band_masked is always 0.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from phovo_tpu_torch.ops import se3
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.utils import profiling
from phovo_tpu_torch.utils.config import PhovoConfig, load_config


class AlignmentResult(NamedTuple):
    """Per-pair alignment result with per-level diagnostics; batched results
    carry a leading pair dimension."""

    state: torch.Tensor  # (..., 6) [x, y, z, yaw, pitch, roll]
    iterations: torch.Tensor  # (..., L) int32 per level (level 0 first)
    gradient_norm: torch.Tensor  # (..., L) final ||J^T r||
    cost: torch.Tensor  # (..., L) final sum r^2
    num_valid: torch.Tensor  # (..., L) valid-pixel count
    # (..., L) pixels dropped by the TPU kernels' banded sampling window;
    # always 0 here, where the kernel samples the whole target
    band_masked: torch.Tensor | float = 0.0

    def transform(self) -> torch.Tensor:
        """The (..., 4, 4) rigid transform of the state."""
        return se3.pose_matrix(self.state)


def stack_levels(state: torch.Tensor, diags) -> AlignmentResult:
    """Per-level (iterations, gradient_norm, cost, num_valid, band_masked)
    float32 tensors, level 0 first -> AlignmentResult with the level axis
    last (state (..., 6), diagnostics (..., L))."""
    dim = state.dim() - 1
    cols = [torch.stack([d[k] for d in diags], dim=dim) for k in range(5)]
    return AlignmentResult(state, cols[0].to(torch.int32), *cols[1:])


def as_float_intensity(img):
    """Normalize a host intensity image for the aligners: uint8 passes
    through unchanged (every backend converts it on the device, so the
    host-to-device copy stays at storage size), other integer dtypes are
    converted here (* 1/255), floats become float32. Tensors pass
    through untouched."""
    if isinstance(img, torch.Tensor):
        return img
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        return arr
    if np.issubdtype(arr.dtype, np.integer):
        return arr.astype(np.float32) * np.float32(1.0 / 255.0)
    return arr.astype(np.float32)


def sequence_scan(align_one, intensities, depths, warm_start: bool) -> AlignmentResult:
    """Align the consecutive pairs of a buffered segment one after the
    other (phovo_tpu's lax.scan as a Python loop): pair k aligns frame k
    to frame k+1. align_one(si, sd, ti, td, init) -> AlignmentResult.
    warm_start starts each pair from the previous pair's state; otherwise
    every pair starts from zero, as the reference does. Returns batched
    results with leading dim B-1."""
    zero = torch.zeros(6, dtype=torch.float32, device=intensities.device)
    init, results = zero, []
    for k in range(intensities.shape[0] - 1):
        res = align_one(
            intensities[k], depths[k], intensities[k + 1], depths[k + 1],
            init if warm_start else zero,
        )
        results.append(res)
        init = res.state
    return AlignmentResult(*(torch.stack(x) for x in zip(*results)))


def prepped_chain(prep: dict, n_pairs: int, align_pair, device) -> AlignmentResult:
    """The warm-started chain over per-frame products computed once: pair k
    aligns frame k to frame k+1 from the state pair k-1 ended at (pair 0
    from zero). prep maps each active level to a tuple of per-frame
    tensors (frames first); align_pair(src, tgt, init_state) aligns one
    pair from the two frames' {level: tuple} products."""

    def frame(k):
        return {level: tuple(x[k] for x in packs) for level, packs in prep.items()}

    state = torch.zeros(6, dtype=torch.float32, device=device)
    results = []
    for k in range(n_pairs):
        res = align_pair(frame(k), frame(k + 1), state)
        results.append(res)
        state = res.state
    return AlignmentResult(*(torch.stack(x) for x in zip(*results)))


# The object API's device unless the caller names another.
DEFAULT_DEVICE = torch.device("cuda")


class PhotoconsistencyOdometryBase:
    """Host-side stateful wrapper over a backend's functional aligner, on
    one torch device: the CUDA card by default."""

    # AlignmentResult.cost convention: GN backends report sum r^2, the
    # trust-region backend 0.5 * sum r^2 (Ceres's)
    COST_IS_HALF_SUM_SQ = False

    def __init__(self, config: PhovoConfig | None = None, device=DEFAULT_DEVICE):
        self.config = config or PhovoConfig()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{type(self).__name__} runs on the CUDA card by default and "
                "torch finds none; pass device=\"cpu\" to run on the CPU"
            )
        self.intrinsics: Intrinsics | None = None
        self._source = None  # (intensity, depth) tensors on self.device
        self._target = None
        self._init_state = torch.zeros(6, dtype=torch.float32, device=self.device)
        self._result: AlignmentResult | None = None

    # -- reference API surface ------------------------------------------------
    def read_configuration_file(self, path) -> None:
        self.config = load_config(path)

    def set_intrinsic_matrix(self, K) -> None:
        self.intrinsics = Intrinsics.from_matrix(K)

    def set_min_depth(self, d: float) -> None:
        self.config = dataclasses.replace(self.config, min_depth=float(d))

    def set_max_depth(self, d: float) -> None:
        self.config = dataclasses.replace(self.config, max_depth=float(d))

    def _frame(self, intensity, depth):
        with profiling.span("phovo.upload"):
            return (
                torch.as_tensor(as_float_intensity(intensity), device=self.device),
                torch.as_tensor(depth, dtype=torch.float32, device=self.device),
            )

    def set_source_frame(self, intensity, depth) -> None:
        self._source = self._frame(intensity, depth)

    def set_target_frame(self, intensity, depth) -> None:
        self._target = self._frame(intensity, depth)

    def set_initial_state_vector(self, state) -> None:
        self._init_state = torch.as_tensor(state, dtype=torch.float32, device=self.device)

    def optimize(self) -> AlignmentResult:
        if self.intrinsics is None:
            raise RuntimeError("set_intrinsic_matrix must be called before optimize")
        if self._source is None or self._target is None:
            raise RuntimeError("source and target frames must be set before optimize")
        with profiling.span("phovo.align"):
            self._result = self.align(
                *self._source, *self._target, self.intrinsics, self._init_state
            )
        return self._result

    def get_optimal_state_vector(self) -> torch.Tensor:
        self._require_result()
        return self._result.state

    def get_optimal_rigid_transformation_matrix(self) -> torch.Tensor:
        self._require_result()
        return se3.pose_matrix(self._result.state)

    def _require_result(self):
        if self._result is None:
            raise RuntimeError("optimize() has not been called")

    # -- functional core (implemented by backends) ----------------------------
    def align(self, source_intensity, source_depth, target_intensity,
              target_depth, intr: Intrinsics, init_state) -> AlignmentResult:
        raise NotImplementedError
