"""Backend-independent alignment API (torch port of
phovo_tpu/models/base.py): results, input conversion, the serial pair loop
and the reference's object interface (CPhotoconsistencyOdometry.h:137-179).

The object API holds a pair's frames and initial state on one device and
runs a backend's functional `align` on them; it runs on the CUDA card
unless the caller names another device (device="cpu"), and raises where
there is no card rather than run elsewhere. Where the backend says a call
can be captured (capturable: on the card, a chain of launches with no host
synchronisation), optimize() replays one CUDA graph of that call
(PairGraph) instead of dispatching its launches one by one, and set_*
copy into the graph's input buffers; every other call runs `align`
eagerly. The functional entries run wherever their tensors live.
phovo_tpu's band-fallback re-run has no counterpart: the GPU kernels
sample the whole target, so band_masked is always 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from phovo_tpu_torch.ops import fused_batch, prep, se3
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

# Captures and replays of the object API's pair graph (PairGraph) and of
# the serving round's graph (parallel/batch.RoundGraph) in this process.
# Each adds one where it happens and nowhere else, so a caller can show
# which of its calls replayed a graph (reset them to 0 before the run,
# read them after).
GRAPH_CAPTURES = 0
GRAPH_REPLAYS = 0
ROUND_GRAPH_CAPTURES = 0
ROUND_GRAPH_REPLAYS = 0

# The launch counters of the kernels a captured call can launch. A capture
# launches nothing, so it leaves them as they were; a replay adds to each
# what the captured call added, so they stay launches in this process.
_LAUNCH_COUNTERS = (
    (prep, "PREP_LAUNCHES"), (fused_batch, "LAUNCHES"), (fused_batch, "TR_LAUNCHES"),
    (fused_batch, "LIN_LAUNCHES"), (fused_batch, "SHARED_LAUNCHES"), (fused_batch, "TR_SHARED_LAUNCHES"),
    (fused_batch, "BI_LAUNCHES"),
)


class CallGraph:
    """A call as a CUDA graph: fn over static device buffers, one a slot
    of SLOTS, captured once per key and replayed for every later call with
    that key. The caller routes here only calls that are a chain of
    launches with no host synchronisation, and builds the key from what the
    captured launches bake in.

    A new key runs the call eagerly first, on the caller's tensors (which
    builds the kernels' library and loads the kernels, as a capture cannot),
    returns that result, and then captures the call over new buffers.
    Buffers are never shared with another key's graph, so a result that
    aliases an input of its eager call stays as it is. The graph writes the
    result's int32 and float32 tensors (floats by their bits) into one flat
    int32 buffer, in the groups `flatten` gives; a replay clones each group
    and returns views of the clones (`unflatten`), so a result the caller
    keeps never changes with a later replay, and a group it keeps holds no
    other group's memory. Each call runs with the inputs' card as the
    current device, on whose streams the capture and the replay launch
    (the kernels launch on their tensors' card), so a graph of a card other
    than the current one is captured and replayed where its launches run.
    `count` adds each capture and replay to the subclass's counters."""

    SLOTS: tuple[str, ...] = ()

    def __init__(self):
        self.key = None
        self.graph = None
        self.out = None  # the flat result the graph writes
        self.groups = []  # ((start, stop) in out, [(dtype, shape)] of its tensors) a group
        self.counts = ()  # what the captured call added to _LAUNCH_COUNTERS
        self.inputs: dict[str, torch.Tensor] = {}  # slot -> the buffer the graph reads

    def flatten(self, result) -> list[list[torch.Tensor]]:
        """The result's tensors in groups, each group cloned on its own."""
        raise NotImplementedError

    def unflatten(self, tensors: list[torch.Tensor]):
        """The result from its tensors in flatten's order."""
        raise NotImplementedError

    def count(self, replay: bool) -> None:
        """Add one to the counter of captures, or of replays."""
        raise NotImplementedError

    def stage(self, slot: str, t: torch.Tensor) -> torch.Tensor | None:
        """t copied into the slot's buffer, where the graph has one of t's
        shape and dtype (on the card, from wherever t lives); else None."""
        buf = self.inputs.get(slot)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            return None
        return buf if buf is t else buf.copy_(t)

    def run(self, fn, inputs, key):
        """fn(*inputs) (inputs in SLOTS order), with inputs[0]'s card as
        the current device: eagerly and then captured where key is not the
        captured call's, else a replay of the graph."""
        with torch.cuda.device(inputs[0].device):
            if key != self.key:
                result = fn(*inputs)
                self._capture(fn, inputs)
                self.key = key
                self.count(replay=False)
                return result
            for slot, t in zip(self.SLOTS, inputs):
                self.stage(slot, t)
            with profiling.span("phovo.replay"):
                self.graph.replay()
            for (module, name), n in zip(_LAUNCH_COUNTERS, self.counts):
                setattr(module, name, getattr(module, name) + n)
            self.count(replay=True)
            tensors = []
            for (start, stop), fields in self.groups:
                flat = self.out[start:stop].clone()
                typed = {torch.int32: flat, torch.float32: flat.view(torch.float32)}
                at = 0
                for dtype, shape in fields:
                    n = math.prod(shape)
                    tensors.append(typed[dtype][at:at + n].view(shape))
                    at += n
            return self.unflatten(tensors)

    def _capture(self, fn, inputs) -> None:
        """Capture fn over new buffers holding copies of the inputs."""
        self.key = self.graph = self.out = None  # frees the old graph's memory first
        self.inputs = {slot: t.clone(memory_format=torch.contiguous_format) for slot, t in zip(self.SLOTS, inputs)}
        before = [getattr(module, name) for module, name in _LAUNCH_COUNTERS]
        graph = torch.cuda.CUDAGraph()
        try:
            # a capture stream on the current card (torch.cuda.graph's own
            # default lives on the card current at its first capture); other
            # threads' CUDA calls (a frame loader's copies) stay allowed
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(), capture_error_mode="thread_local"):
                groups = self.flatten(fn(*(self.inputs[slot] for slot in self.SLOTS)))
                out = torch.cat([t.reshape(-1).view(torch.int32) for group in groups for t in group])
        finally:
            self.counts = tuple(getattr(module, name) - n for (module, name), n in zip(_LAUNCH_COUNTERS, before))
            for (module, name), n in zip(_LAUNCH_COUNTERS, before):
                setattr(module, name, n)
        self.groups, at = [], 0
        for group in groups:
            n = sum(t.numel() for t in group)
            self.groups.append(((at, at + n), [(t.dtype, tuple(t.shape)) for t in group]))
            at += n
        self.graph, self.out = graph, out


class PairGraph(CallGraph):
    """One object API's optimize() as a CUDA graph (CallGraph): the
    backend's align over static device buffers (both frames and the
    initial state). The key is the config, the intrinsics, and each
    input's shape, dtype and device (a backend whose align reads anything
    else answers capturable() False). The result is one group: the state,
    then the per-level iterations, gradient norm, cost, valid count and
    band_masked."""

    SLOTS = ("source", "source depth", "target", "target depth", "init")

    def flatten(self, result: AlignmentResult) -> list[list[torch.Tensor]]:
        return [list(result)]

    def unflatten(self, tensors: list[torch.Tensor]) -> AlignmentResult:
        return AlignmentResult(*tensors)

    def count(self, replay: bool) -> None:
        global GRAPH_CAPTURES, GRAPH_REPLAYS
        if replay:
            GRAPH_REPLAYS += 1
        else:
            GRAPH_CAPTURES += 1


class PhotoconsistencyOdometryBase:
    """Stateful wrapper over a backend's functional aligner, on one torch
    device: the CUDA card by default. Calls the backend says it can
    capture replay a PairGraph."""

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
        self._graph: PairGraph | None = None  # from the first captured call

    # -- reference API surface ------------------------------------------------
    def read_configuration_file(self, path) -> None:
        self.config = load_config(path)

    def set_intrinsic_matrix(self, K) -> None:
        self.intrinsics = Intrinsics.from_matrix(K)

    def set_min_depth(self, d: float) -> None:
        self.config = dataclasses.replace(self.config, min_depth=float(d))

    def set_max_depth(self, d: float) -> None:
        self.config = dataclasses.replace(self.config, max_depth=float(d))

    def _to_device(self, t: torch.Tensor, slot: str) -> torch.Tensor:
        """t on the object's device: copied into the pair graph's buffer
        for `slot` where it has one of t's shape and dtype, else moved."""
        staged = self._graph.stage(slot, t) if self._graph is not None else None
        return staged if staged is not None else t.to(self.device)

    def _frame(self, intensity, depth, slots):
        with profiling.span("phovo.upload"):
            return (
                self._to_device(torch.as_tensor(as_float_intensity(intensity)), slots[0]),
                self._to_device(torch.as_tensor(depth, dtype=torch.float32), slots[1]),
            )

    def set_source_frame(self, intensity, depth) -> None:
        self._source = self._frame(intensity, depth, ("source", "source depth"))

    def set_target_frame(self, intensity, depth) -> None:
        self._target = self._frame(intensity, depth, ("target", "target depth"))

    def set_initial_state_vector(self, state) -> None:
        self._init_state = self._to_device(torch.as_tensor(state, dtype=torch.float32), "init")

    def optimize(self) -> AlignmentResult:
        if self.intrinsics is None:
            raise RuntimeError("set_intrinsic_matrix must be called before optimize")
        if self._source is None or self._target is None:
            raise RuntimeError("source and target frames must be set before optimize")
        with profiling.span("phovo.align"):
            (si, sd), (ti, td) = self._source, self._target
            if si.dim() == 2 and sd.shape == ti.shape == si.shape and self.capturable(
                    si.device, tuple(si.shape), si.dtype, sd.dtype, ti.dtype):
                if self._graph is None:
                    self._graph = PairGraph()
                inputs = (si, sd, ti, td, self._init_state)
                key = (self.config, self.intrinsics, tuple((t.shape, t.dtype, t.device) for t in inputs))
                self._result = self._graph.run(
                    lambda *x: self.align(*x[:4], self.intrinsics, x[4]), inputs, key)
            else:
                # the graph goes; held tensors that are its buffers stay
                # as they are, since no set_* writes into them again
                self._graph = None
                self._result = self.align(si, sd, ti, td, self.intrinsics, self._init_state)
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

    def capturable(self, device, shape, source_dtype, depth_dtype, target_dtype) -> bool:
        """Whether align on `device`, with a source intensity, source depth
        and target intensity of this (H, W) shape and these dtypes, is a
        chain of launches with no host synchronisation that one CUDA graph
        can replay (PairGraph). The base answers False: every call runs
        eagerly."""
        return False
