"""Keyframe visual odometry with loop closures and a pose-graph back end
(torch port of phovo_tpu/models/keyframe.py).

The reference integrates poses frame to frame with no drift correction
(PhotoconsistencyVisualOdometry.cpp:233-234). On top of the same aligners:

  - frames are tracked against the current KEYFRAME, not the previous
    frame;
  - a frame becomes a new keyframe when its tracked motion or its
    valid-pixel overlap crosses a threshold, adding an odometry edge;
  - a new keyframe near an old, non-adjacent one is aligned to it
    photometrically from the predicted relative pose; a well-supported,
    geometrically consistent alignment adds a loop edge;
  - finalize() optimizes the pose graph (parallel/pose_graph.py),
    optionally refines the keyframe poses and a sparse landmark map by
    photometric bundle adjustment (parallel/photometric_ba.py), and
    recomposes every frame pose from its optimized keyframe.

Everything on the device lives on the odometry object's device (the card
by default): the keyframes' frames (Keyframe.dev_*), the tracked chunks,
the closure batches, the pose-graph solve and the bundle adjustment.
run_chunked tracks a chunk of frames against the keyframe in one
dispatch: level-major through the shared-source level kernels (analytic:
models/analytic.py::track_chunk_levelmajor; ceres: models/autodiff.py::
track_chunk_levelmajor_tr), or the serial warm-started scan
(track_sequence_chunk). Loop-closure candidates of the analytic backend
align in one batch (parallel/batch.py::align_batch); the other backends
align them one by one through the object API.

finalize(mesh=...) runs the pose graph and the bundle adjustment over a
mesh of ranks (parallel/mesh.py), each rank holding the same keyframes:
the edges and observations are sharded, the result is the same on every
rank; tracking stays on each rank's own card. phovo_tpu's band fallback
has nothing to catch here: the GPU kernels sample the whole target, so
band_masked is always 0; band_fallback is accepted and stored, and
band_fallbacks stays 0.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from phovo_tpu_torch.datasets.tum import RGBDFrame
from phovo_tpu_torch.models.analytic import (
    PhotoconsistencyOdometryAnalytic,
    prep_keyframe,
    track_chunk_levelmajor,
    track_levelmajor_eligible,
    track_sequence_chunk,
)
from phovo_tpu_torch.models.autodiff import (
    PhotoconsistencyOdometryAutodiff,
    _check_supported,
    tr_track_levelmajor_eligible,
    track_chunk_levelmajor_tr,
)
from phovo_tpu_torch.models.base import AlignmentResult, PhotoconsistencyOdometryBase
from phovo_tpu_torch.ops import se3
from phovo_tpu_torch.ops.prep import device_unit_intensity
from phovo_tpu_torch.parallel.batch import align_batch
from phovo_tpu_torch.parallel.photometric_ba import (
    build_photometric_global,
    optimize_photometric_bundle,
    refine_photometric_windows,
    select_landmark_pixels,
    window_starts,
)
from phovo_tpu_torch.parallel.pose_graph import PoseGraph, optimize_pose_graph

# phovo_tpu's default fraction of band-masked pixels that re-runs a pair
BAND_FALLBACK_DEFAULT = 0.02
LEVELMAJOR_MODES = ("auto", "off", "interpret")


@dataclasses.dataclass
class Keyframe:
    index: int  # keyframe id (0-based)
    frame_index: int  # source frame index in the stream
    timestamp: float
    intensity: np.ndarray
    depth: np.ndarray  # float32 metres
    pose: np.ndarray  # (4, 4) world <- keyframe (current estimate)
    # device copies (intensity in its storage dtype), uploaded once: every
    # frame tracks against the current keyframe
    dev_intensity: torch.Tensor | None = None
    dev_depth: torch.Tensor | None = None
    device: object = "cpu"

    def __post_init__(self):
        if self.dev_intensity is None:
            self.dev_intensity = torch.as_tensor(np.asarray(self.intensity), device=self.device)
        if self.dev_depth is None:
            self.dev_depth = torch.as_tensor(np.asarray(self.depth, np.float32), device=self.device)


@dataclasses.dataclass
class TrackedFrame:
    frame_index: int
    timestamp: float
    keyframe_index: int
    rel_to_keyframe: np.ndarray  # (4, 4): pose = kf.pose @ rel
    pose: np.ndarray  # (4, 4) world pose (pre-optimization estimate)
    align_iterations: np.ndarray
    num_valid: float


@dataclasses.dataclass
class LoopClosure:
    from_kf: int
    to_kf: int
    relative: np.ndarray  # (4, 4): T_from^{-1} T_to measured
    mean_residual: float


def to_host(res: AlignmentResult) -> AlignmentResult:
    """An AlignmentResult moved to the host in ONE device-to-host copy (the
    fields flattened into one float32 buffer; iteration counts are exact
    in float32)."""
    flat = torch.cat([x.reshape(-1).to(torch.float32) for x in res]).cpu()
    out, at = [], 0
    for x in res:
        out.append(flat[at:at + x.numel()].reshape(x.shape).to(x.dtype))
        at += x.numel()
    return AlignmentResult(*out)


def _finest_level(iterations) -> int:
    """The finest pyramid level that ran (diagnostics are stacked level 0
    first; skipped levels report zeros)."""
    ran = np.nonzero(np.asarray(iterations) > 0)[0]
    return int(ran[0]) if len(ran) else 0


class KeyframeVisualOdometry:
    """Keyframe tracker and pose-graph back end over an alignment backend's
    object API (its config, intrinsics and device)."""

    def __init__(
        self,
        odometry: PhotoconsistencyOdometryBase,
        kf_translation: float = 0.15,  # metres
        kf_rotation: float = 0.15,  # radians (euler norm)
        kf_min_valid_fraction: float = 0.5,
        loop_radius: float = 0.6,  # metres between keyframe positions
        loop_min_gap: int = 5,  # minimum keyframe-index separation
        loop_max_mean_residual: float = 0.05,  # intensity units (0..1)
        loop_min_valid_fraction: float = 0.4,
        loop_weight: float = 10.0,
        loop_max_translation_dev: float = 0.2,  # metres vs predicted relative
        loop_max_rotation_dev: float = 0.3,  # radians vs predicted relative
        band_fallback: float = BAND_FALLBACK_DEFAULT,
        pg_solver: str = "auto",  # pose-graph solver: auto/dense/cg
        pg_incremental: int = 0,  # re-solve the graph every N promotions
    ):
        self.odometry = odometry
        self.pg_solver = pg_solver
        # every pg_incremental promotions the current graph is solved and
        # the keyframe poses rebased, so later closure searches and poses
        # see the drift-corrected map; finalize() still runs the final solve
        self.pg_incremental = pg_incremental
        self.incremental_solves = 0
        self.incremental_latencies: list[float] = []
        # (graph build and closure flush, solve and fetch, rebase) seconds
        self.incremental_breakdown: list[tuple] = []
        self.band_fallback = band_fallback  # never engages: band_masked is 0
        self.band_fallbacks = 0
        self.kf_translation = kf_translation
        self.kf_rotation = kf_rotation
        self.kf_min_valid_fraction = kf_min_valid_fraction
        self.loop_radius = loop_radius
        self.loop_min_gap = loop_min_gap
        self.loop_max_mean_residual = loop_max_mean_residual
        self.loop_min_valid_fraction = loop_min_valid_fraction
        self.loop_weight = loop_weight
        self.loop_max_translation_dev = loop_max_translation_dev
        self.loop_max_rotation_dev = loop_max_rotation_dev

        self.keyframes: list[Keyframe] = []
        self.tracked: list[TrackedFrame] = []
        self.odometry_edges: list[tuple[int, int, np.ndarray]] = []  # (i, j, T_i^-1 T_j)
        self.loop_closures: list[LoopClosure] = []
        # closure batches still on the device: (new keyframe index,
        # [(old index, rel_pred)], device result, full-resolution pixels);
        # gated at the next flush (build_pose_graph, the end of a run)
        self._pending_closures: list[tuple] = []
        # the bundle-adjusted landmarks (world) and their host intensities,
        # set by finalize(ba_iterations > 0)
        self.map_points: np.ndarray | None = None
        self.map_intensity: np.ndarray | None = None

    # -- alignment helpers ---------------------------------------------------

    @staticmethod
    def _finest_stats(res) -> tuple[float, float, int]:
        """(cost, num_valid, level) at the finest pyramid level that ran:
        num_valid counts pixels AT THAT LEVEL (N / 4^level of the frame)."""
        lvl = _finest_level(res.iterations)
        return float(np.asarray(res.cost)[lvl]), float(np.asarray(res.num_valid)[lvl]), lvl

    def _align(self, src_i, src_d, tgt_i, tgt_d, init_state=None):
        """One pair through the odometry's object API, the result on the
        host."""
        self.odometry.set_source_frame(src_i, src_d)
        self.odometry.set_target_frame(tgt_i, tgt_d)
        self.odometry.set_initial_state_vector(
            np.zeros(6, np.float32) if init_state is None else init_state
        )
        return to_host(self.odometry.optimize())

    def _observe(self, kf: Keyframe, fr: RGBDFrame, frame_index: int, state, iterations,
                 nvalid: float) -> tuple[TrackedFrame, bool, np.ndarray]:
        """Record a frame tracked against kf at state; (the tracked frame,
        whether it crosses a promotion threshold, rel)."""
        rel = np.linalg.inv(se3.pose_matrix_np(state))  # kf -> frame motion
        pose = kf.pose @ rel
        tf = TrackedFrame(
            frame_index=frame_index, timestamp=fr.timestamp, keyframe_index=kf.index,
            rel_to_keyframe=rel, pose=pose, align_iterations=np.asarray(iterations),
            num_valid=nvalid,
        )
        self.tracked.append(tf)
        lvl = _finest_level(iterations)
        # num_valid counts pixels at the finest level that ran: the overlap
        # is taken against that level's pixel count
        overlap = nvalid / (float(np.asarray(fr.intensity).size) / 4.0**lvl)
        promote = (
            float(np.linalg.norm(state[:3])) > self.kf_translation
            or float(np.linalg.norm(state[3:])) > self.kf_rotation
            or overlap < self.kf_min_valid_fraction
        )
        return tf, promote, rel

    def _promote_tracked(self, kf: Keyframe, fr: RGBDFrame, tf: TrackedFrame, rel) -> None:
        new_kf = self._promote(fr, tf.frame_index, tf.pose)
        self.odometry_edges.append((kf.index, new_kf.index, rel.copy()))
        self._try_loop_closure(new_kf, defer=True)
        self._maybe_incremental_solve(new_kf.index)

    # -- main loop -----------------------------------------------------------

    def run(self, frames: Iterable[RGBDFrame]) -> Iterator[TrackedFrame]:
        """Track frame after frame against the current keyframe through the
        odometry's object API, warm-started from the frame before (from
        zero after a promotion)."""
        it = iter(frames)
        first = next(it, None)
        if first is None:
            return
        self._promote(first, 0, np.eye(4))
        last_rel_state = np.zeros(6, np.float32)
        for frame_index, fr in enumerate(it, start=1):
            kf = self.keyframes[-1]
            res = self._align(kf.dev_intensity, kf.dev_depth, fr.intensity, fr.depth, last_rel_state)
            state = np.asarray(res.state)
            _, nvalid, _ = self._finest_stats(res)
            tf, promote, rel = self._observe(kf, fr, frame_index, state, res.iterations, nvalid)
            yield tf
            if promote:
                self._promote_tracked(kf, fr, tf, rel)
                last_rel_state = np.zeros(6, np.float32)
            else:
                last_rel_state = state.astype(np.float32)
        self.flush_loop_closures()

    def run_chunked(
        self, frames: Iterable[RGBDFrame], chunk: int = 16,
        depth_scale: float | None = None,
        levelmajor: str = "auto",
    ) -> Iterator[TrackedFrame]:
        """run() with the frames tracked a chunk at a time, one dispatch per
        chunk; the promotion walk stays on the host, and a frame that
        promotes mid-chunk sends the chunk's tail back to be tracked
        against the new keyframe (its results against the old one are
        dropped). Each frame is uploaded once, in its storage dtype.

        levelmajor: 'auto' tracks the chunk level-major, every frame from
        the last solved state, through the shared-source level kernel
        (models/analytic.py::track_chunk_levelmajor, the keyframe's packs
        prepped once at its first chunk), where track_levelmajor_eligible
        passes; 'off' runs the serial warm-started scan
        (track_sequence_chunk). 'interpret' (phovo_tpu's Pallas interpret
        mode for CPU tests) is taken as 'auto': CPU tensors run the plain
        versions anyway. No value routes a Student-t chunk level-major:
        phovo_tpu's gate sends it to the scan, and so does this one.

        The ceres backend (PhotoconsistencyOdometryAutodiff) always tracks
        level-major through the shared-source trust-region kernel
        (models/autodiff.py::track_chunk_levelmajor_tr); 'off' and
        jacobian_mode='jacfwd' raise RuntimeError, as in phovo_tpu. Other
        backends raise ValueError.

        depth_scale: frames carry raw depth counts (uint16), converted on
        the device; promoted keyframes are converted once, on the host."""
        if levelmajor not in LEVELMAJOR_MODES:
            raise ValueError(f"levelmajor={levelmajor!r}; expected one of {LEVELMAJOR_MODES}")
        odo = self.odometry
        cfg, intr, dev = odo.config, odo.intrinsics, odo.device
        if intr is None:
            raise RuntimeError("set_intrinsic_matrix before run_chunked")
        if isinstance(odo, PhotoconsistencyOdometryAutodiff):
            _check_supported(cfg, odo.jacobian_mode)
            if levelmajor == "off" or not tr_track_levelmajor_eligible(cfg, odo.jacobian_mode):
                raise RuntimeError(
                    "run_chunked with the ceres backend tracks level-major "
                    "only (the linearizer Jacobian); use run() for the "
                    "per-frame path"
                )
            lm_track, track_fn = True, track_chunk_levelmajor_tr
            # the trust-region level reads four geometry rows whatever
            # gradient_at says
            prep_cfg = dataclasses.replace(cfg, gradient_at="warped")
        elif isinstance(odo, PhotoconsistencyOdometryAnalytic):
            lm_track = levelmajor != "off" and track_levelmajor_eligible(cfg, odo.use_fused)
            track_fn, prep_cfg = track_chunk_levelmajor, cfg
        else:
            raise ValueError(
                f"run_chunked tracks with the analytic or the ceres backend, not "
                f"{type(odo).__name__}; use run()"
            )

        def metric(fr: RGBDFrame) -> RGBDFrame:
            """Raw depth counts -> metric float32 (promotions only)."""
            d = np.asarray(fr.depth)
            if depth_scale is not None and d.dtype == np.uint16:
                return dataclasses.replace(fr, depth=d.astype(np.float32) * np.float32(depth_scale))
            return fr

        it = iter(frames)
        first = next(it, None)
        if first is None:
            return
        self._promote(metric(first), 0, np.eye(4))
        last_rel_state = np.zeros(6, np.float32)
        frame_index = 0
        buf: list[RGBDFrame] = []
        dev_I: list[torch.Tensor] = []  # the buffered frames on the device
        dev_D: list[torch.Tensor] = []  # their depths (the serial scan only)
        kf_prep, kf_prep_index = None, -1

        def refill():
            while len(buf) < chunk:
                fr = next(it, None)
                if fr is None:
                    break
                buf.append(fr)
                dev_I.append(torch.as_tensor(np.asarray(fr.intensity), device=dev))
                if not lm_track:  # level-major frames are targets only: no depth
                    d = np.asarray(fr.depth)
                    dev_D.append(torch.as_tensor(d if depth_scale is not None else d.astype(np.float32),
                                                 device=dev))

        def track(kf, init):
            nonlocal kf_prep, kf_prep_index
            I = torch.stack(dev_I)
            if not lm_track:
                return to_host(track_sequence_chunk(
                    kf.dev_intensity, kf.dev_depth, I, torch.stack(dev_D), intr,
                    torch.as_tensor(init, device=dev), cfg, odo.use_fused, depth_scale=depth_scale,
                ))
            if kf.index != kf_prep_index:
                kf_prep = prep_keyframe(kf.dev_intensity, kf.dev_depth, intr, prep_cfg)
                kf_prep_index = kf.index
            # every frame starts from the last solved state (phovo_tpu's
            # anchored inits: a constant-velocity extrapolation was refuted
            # there, keyframe.py:321-337)
            inits = torch.as_tensor(np.broadcast_to(init, (len(buf), 6)).copy(), device=dev)
            return to_host(track_fn(kf_prep, I, intr, inits, cfg))

        while True:
            refill()
            if not buf:
                break
            kf = self.keyframes[-1]
            res = track(kf, last_rel_state)
            consumed = 0
            for k, fr in enumerate(buf):
                frame_index += 1
                consumed += 1
                state = np.asarray(res.state[k])
                iters_k = np.asarray(res.iterations[k])
                nvalid = float(np.asarray(res.num_valid[k])[_finest_level(iters_k)])
                tf, promote, rel = self._observe(kf, fr, frame_index, state, iters_k, nvalid)
                yield tf
                if promote:
                    self._promote_tracked(kf, metric(fr), tf, rel)
                    last_rel_state = np.zeros(6, np.float32)
                    break  # re-track the chunk's tail against the new keyframe
                last_rel_state = state.astype(np.float32)
            del buf[:consumed], dev_I[:consumed], dev_D[:consumed]
        self.flush_loop_closures()

    def _maybe_incremental_solve(self, new_index: int) -> None:
        """Every pg_incremental promotions: solve the current pose graph and
        rebase the keyframe poses."""
        if self.pg_incremental <= 0 or new_index < 2 or new_index % self.pg_incremental != 0:
            return
        t0 = time.perf_counter()
        graph = self.build_pose_graph()
        t1 = time.perf_counter()
        states, _ = optimize_pose_graph(
            graph, iterations=10, solver=self.pg_solver, device=self.odometry.device,
        )
        states = states.cpu().numpy().astype(np.float64)
        t2 = time.perf_counter()
        for k, kf in enumerate(self.keyframes):
            kf.pose = se3.pose_matrix_np(states[k])
        t3 = time.perf_counter()
        self.incremental_solves += 1
        self.incremental_latencies.append(t3 - t0)
        self.incremental_breakdown.append((t1 - t0, t2 - t1, t3 - t2))

    def _promote(self, fr: RGBDFrame, frame_index: int, pose: np.ndarray) -> Keyframe:
        kf = Keyframe(
            index=len(self.keyframes), frame_index=frame_index, timestamp=fr.timestamp,
            intensity=np.asarray(fr.intensity), depth=np.asarray(fr.depth),
            pose=np.asarray(pose), device=self.odometry.device,
        )
        self.keyframes.append(kf)
        return kf

    def _closure_candidates(self, new_kf: Keyframe):
        """Old keyframes within loop_radius of new_kf and at least
        loop_min_gap keyframes back, each with the PREDICTED relative pose
        (from the current estimates) as its alignment init: a zero-init
        alignment of far-apart viewpoints can settle in a wrong basin that
        still looks photometrically plausible."""
        pos = new_kf.pose[:3, 3]
        return [
            (old, np.linalg.inv(old.pose) @ new_kf.pose)
            for old in self.keyframes[: max(0, new_kf.index - self.loop_min_gap)]
            if np.linalg.norm(old.pose[:3, 3] - pos) <= self.loop_radius
        ]

    def _gate_closure(self, new_kf_index, old_index, rel_pred, state, cost, nvalid, lvl,
                      npix_full, half_sum_sq: bool) -> None:
        """The photometric-support and geometric-consistency gates on one
        candidate's alignment; the loop edge is appended if both pass."""
        npix = npix_full / 4.0**lvl  # pixels at the finest level that ran
        if half_sum_sq:  # the trust-region backend reports 0.5 sum r^2
            cost = 2.0 * cost
        mean_res = np.sqrt(cost / max(nvalid, 1.0))
        if nvalid / npix < self.loop_min_valid_fraction or mean_res > self.loop_max_mean_residual:
            return
        rel = np.linalg.inv(se3.pose_matrix_np(state))
        # a measured relative pose far from the prediction is a wrong-basin
        # alignment, not a closure
        dev = np.linalg.inv(rel_pred) @ rel
        trans_dev = float(np.linalg.norm(dev[:3, 3]))
        rot_dev = float(np.arccos(np.clip((np.trace(dev[:3, :3]) - 1.0) / 2.0, -1, 1)))
        if trans_dev > self.loop_max_translation_dev or rot_dev > self.loop_max_rotation_dev:
            return
        self.loop_closures.append(LoopClosure(old_index, new_kf_index, rel, mean_res))

    def _analytic_batch_context(self):
        """(config, use_fused, intrinsics) when the backend takes the
        batched closure alignment (analytic semantics), else None."""
        odo = self.odometry
        if not isinstance(odo, PhotoconsistencyOdometryAnalytic) or odo.intrinsics is None:
            return None
        return odo.config, odo.use_fused, odo.intrinsics

    def _try_loop_closure(self, new_kf: Keyframe, defer: bool = False) -> None:
        """Search for loop closures against new_kf. With defer and the
        analytic backend, every candidate aligns in ONE batch
        (parallel/batch.py::align_batch, one level-kernel launch per level)
        whose result stays on the device until the next flush; otherwise
        each candidate aligns now through the object API."""
        cands = self._closure_candidates(new_kf)
        if not cands:
            return
        ctx = self._analytic_batch_context() if defer else None
        if ctx is None:
            half = getattr(self.odometry, "COST_IS_HALF_SUM_SQ", False)
            for old, rel_pred in cands:
                init = se3.matrix_to_state_np(np.linalg.inv(rel_pred)).astype(np.float32)
                res = self._align(old.dev_intensity, old.dev_depth, new_kf.dev_intensity,
                                  new_kf.dev_depth, init)
                cost, nvalid, lvl = self._finest_stats(res)
                self._gate_closure(new_kf.index, old.index, rel_pred, np.asarray(res.state), cost,
                                   nvalid, lvl, new_kf.intensity.size, half)
            return
        cfg, use_fused, intr = ctx
        B = len(cands)
        inits = se3.matrix_to_state_np(np.stack([np.linalg.inv(rp) for _, rp in cands]))
        dev = new_kf.dev_intensity.device
        res = align_batch(
            torch.stack([o.dev_intensity for o, _ in cands]),
            torch.stack([o.dev_depth for o, _ in cands]),
            new_kf.dev_intensity.expand(B, *new_kf.dev_intensity.shape),
            new_kf.dev_depth.expand(B, *new_kf.dev_depth.shape),
            intr, torch.as_tensor(inits.astype(np.float32), device=dev), cfg, use_fused,
        )
        self._pending_closures.append(
            (new_kf.index, [(o.index, rp) for o, rp in cands], res, new_kf.intensity.size)
        )

    def flush_loop_closures(self) -> None:
        """Gate every closure batch still on the device, all fetched in one
        device-to-host copy."""
        pending, self._pending_closures = self._pending_closures, []
        if not pending:
            return
        host = to_host(AlignmentResult(*(torch.cat(f) for f in zip(*(p[2] for p in pending)))))
        at = 0
        for new_index, cand_meta, _, npix_full in pending:
            for old_index, rel_pred in cand_meta:
                lvl = _finest_level(host.iterations[at])
                self._gate_closure(
                    new_index, old_index, rel_pred, np.asarray(host.state[at]),
                    float(host.cost[at, lvl]), float(host.num_valid[at, lvl]), lvl, npix_full,
                    half_sum_sq=False,
                )
                at += 1

    # -- back end ------------------------------------------------------------

    def build_pose_graph(self) -> PoseGraph:
        """The keyframe graph as numpy arrays: the current keyframe states,
        the odometry edges (weight 1) and the loop edges (loop_weight)."""
        self.flush_loop_closures()
        states = se3.matrix_to_state_np(np.stack([k.pose for k in self.keyframes])).astype(np.float32)
        edges = [(i, j, rel, 1.0) for i, j, rel in self.odometry_edges] + [
            (lc.from_kf, lc.to_kf, lc.relative, self.loop_weight) for lc in self.loop_closures
        ]
        if not edges:  # one keyframe: a self-consistent null graph
            edges = [(0, 0, np.eye(4), 0.0)]
        ei, ej, rels, ws = zip(*edges)
        return PoseGraph(
            states=states,
            edges_i=np.asarray(ei, np.int32),
            edges_j=np.asarray(ej, np.int32),
            measurements=se3.matrix_to_state_np(np.stack(rels)).astype(np.float32),
            weights=np.asarray(ws, np.float32),
        )

    def finalize(
        self,
        mesh=None,
        iterations: int = 10,
        ba_iterations: int = 0,
        ba_window: int = 8,
        ba_grid: int = 8,
        ba_damping: float = 1e-4,
        ba_robust_delta: float | None = 0.1,
        ba_scope: str = "window",
        ba_covis: int = 6,
        ba_occ_gate: float | None = 0.3,
        ba_z_robust_delta: float | None = 0.02,
    ) -> list[TrackedFrame]:
        """Optimize the keyframe poses over the pose graph (on the
        odometry's device), optionally refine them with photometric bundle
        adjustment, and recompose every tracked frame's pose from its
        keyframe's; returns the tracked frames with `pose` updated in
        place. finalize_timings holds the seconds of the graph build, the
        solve and the refinement (the card synchronized before each
        reading).

        ba_iterations > 0 refines poses AND sparse landmarks against the
        keyframes' stored images (parallel/photometric_ba.py) and fills
        map_points and map_intensity. ba_scope 'window': sliding windows of
        ba_window keyframes, each anchored on its first pose's refined
        estimate; 'global': one problem over all keyframes, each landmark
        observed by its ba_covis nearest keyframes, the Schur path routed
        by size. ba_occ_gate drops observations whose predicted and
        measured depths differ by more than that many metres (an occluded
        landmark sees another surface); ba_robust_delta is a Huber delta on
        the photometric row (intensity units) and ba_z_robust_delta on the
        depth row (metres). 0 or None disables either. mesh
        (parallel/mesh.py): every rank of the mesh calls finalize on a
        tracker holding the same keyframes; the pose graph's edges and the
        bundle adjustments' observations are split over the ranks and
        every rank ends with the same poses and map (a one-rank mesh: the
        unsharded bits)."""
        if ba_scope not in ("window", "global"):
            raise ValueError(f"ba_scope={ba_scope!r}")
        ba_robust_delta = ba_robust_delta or None
        ba_occ_gate = ba_occ_gate or float("inf")
        ba_z_robust_delta = ba_z_robust_delta or None
        self.finalize_timings: dict[str, float] = {}
        t0 = time.perf_counter()
        if len(self.keyframes) >= 2:
            graph = self.build_pose_graph()
            t1 = time.perf_counter()
            self.finalize_timings["pg_build"] = t1 - t0
            states, _ = optimize_pose_graph(
                graph, mesh=mesh, iterations=iterations, solver=self.pg_solver, device=self.odometry.device,
            )
            states = states.cpu().numpy().astype(np.float64)
            self.finalize_timings["pg_solve"] = time.perf_counter() - t1
            for k, kf in enumerate(self.keyframes):
                kf.pose = se3.pose_matrix_np(states[k])
        self.finalize_timings["pose_graph"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if ba_iterations > 0 and len(self.keyframes) >= 2:
            if ba_scope == "global":
                self._refine_photometric_global(mesh, ba_iterations, ba_grid, ba_damping, ba_robust_delta, ba_covis,
                                                ba_occ_gate, ba_z_robust_delta)
            else:
                self._refine_photometric(mesh, ba_iterations, ba_window, ba_grid, ba_damping, ba_robust_delta,
                                         ba_occ_gate, ba_z_robust_delta)
        _synchronize(self.odometry.device)
        self.finalize_timings["photometric_ba"] = time.perf_counter() - t0
        for tf in self.tracked:
            tf.pose = self.keyframes[tf.keyframe_index].pose @ tf.rel_to_keyframe
        return self.tracked

    # -- photometric bundle adjustment ----------------------------------------

    def _ba_intrinsics(self):
        if self.odometry.intrinsics is None:
            raise RuntimeError("photometric BA needs intrinsics on the odometry backend")
        return self.odometry.intrinsics

    def _keyframe_stacks(self):
        """The keyframes' device images as (M, H, W) float32 stacks
        (intensity in 0..1, converted on the device) and their host
        states (M, 6)."""
        kfs = self.keyframes
        dev_I = device_unit_intensity(torch.stack([k.dev_intensity for k in kfs])).to(torch.float32)
        dev_D = torch.stack([k.dev_depth for k in kfs])
        states = se3.matrix_to_state_np(np.stack([k.pose for k in kfs])).astype(np.float32)
        return dev_I, dev_D, states

    def _set_poses(self, kfs, states: torch.Tensor) -> None:
        refined = states.cpu().numpy().astype(np.float64)
        for k, kf in enumerate(kfs):
            kf.pose = se3.pose_matrix_np(refined[k])

    def _refine_photometric(
        self, mesh, iterations: int, window: int, grid: int, damping: float,
        robust_delta: float | None = None, occ_gate: float = 0.3, robust_z_delta: float | None = 0.02,
    ) -> None:
        """Windowed photometric BA over all keyframes: every sliding window
        built and solved on the device from the keyframe stacks
        (refine_photometric_windows: each window's Schur path routed by
        size, its observations sharded over `mesh`). phovo_tpu pads the
        keyframes and the windows to reuse one compiled program; the port
        runs unpadded."""
        intr = self._ba_intrinsics()
        M = len(self.keyframes)
        window = max(2, min(window, M))
        kfs = self.keyframes
        starts = window_starts(M, window)
        sel = np.stack([select_landmark_pixels(k.intensity, k.depth, grid=grid) for k in kfs])
        dev_I, dev_D, states = self._keyframe_stacks()
        dev = dev_I.device
        refined, points, refs, lm_valid = refine_photometric_windows(
            dev_I, dev_D, torch.from_numpy(states).to(dev), torch.from_numpy(sel).to(dev), starts, intr, damping,
            window=window, grid=grid, iterations=iterations, robust_delta=robust_delta, occ_gate=float(occ_gate),
            robust_z_delta=robust_z_delta, mesh=mesh,
        )
        self._set_poses(kfs, refined)
        pts = points.cpu().numpy().astype(np.float64).reshape(-1, 3)
        ref_i = refs.cpu().numpy().reshape(-1)
        keep = lm_valid.cpu().numpy().reshape(-1) & (np.linalg.norm(pts, axis=1) > 1e-9)
        self.map_points = pts[keep]
        self.map_intensity = ref_i[keep]

    def _refine_photometric_global(
        self, mesh, iterations: int, grid: int, damping: float, robust_delta: float | None, covis: int,
        occ_gate: float = 0.3, robust_z_delta: float | None = 0.02,
    ) -> None:
        """ba_scope='global': one photometric BA over ALL keyframes
        (build_photometric_global) on the keyframes' device stacks,
        schur='auto' (the sparse path past the dense budget). phovo_tpu
        pads the keyframe count to a multiple of 16 with inert keyframes to
        reuse compiled programs; the port runs unpadded."""
        intr = self._ba_intrinsics()
        kfs = self.keyframes
        dev_I, dev_D, states = self._keyframe_stacks()
        problem = build_photometric_global(
            np.stack([k.intensity for k in kfs]), np.stack([k.depth for k in kfs]).astype(np.float32), states, intr,
            grid=grid, max_covis=covis, occ_gate=occ_gate, device_intensities=dev_I, device_depths=dev_D,
        )
        refined, points, _ = optimize_photometric_bundle(
            problem, intr, mesh=mesh, iterations=iterations, damping=damping, fixed_first=True,
            robust_delta=robust_delta, schur="auto", robust_z_delta=robust_z_delta,
        )
        self._set_poses(kfs, refined)
        pts = points.cpu().numpy().astype(np.float64)
        keep = np.linalg.norm(pts, axis=1) > 1e-9  # zero rows: invalid landmark slots
        self.map_points = pts[keep]
        self.map_intensity = problem.ref_intensity.cpu().numpy()[keep]


def _synchronize(device) -> None:
    """Wait for the card's queued work (a no-op off the card), so that a
    host clock reading covers it."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
