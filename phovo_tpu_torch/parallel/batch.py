"""Batched alignment and single-device multi-stream serving (torch port of
phovo_tpu/parallel/batch.py's single-device entries).

phovo_tpu vmaps its per-pair aligner over a batch and shards the batch
over a device mesh. On one GPU the batch is the level kernel's pair axis:
independent pairs advance in one launch per level, each pair in its own
thread block, freezing on its own. So

  * align_batch aligns B pairs from per-pair inits with one Gauss-Newton
    level launch per active level: on the card each pair gets the bits of
    align_analytic on it alone;
  * align_sequences flattens S streams' zero-init pairs into one
    level-major batch; a stream that is not level-major (warm_start,
    gradient_at='source', use_fused=False) runs as the port's
    align_sequence, so a served stream is that stream's own chain;
  * align_sequences_multi walks time, one align_batch_fused (the
    multi-stream route, phovo_tpu's B7) per step;
  * serve_sequences_chunk is the chunked streaming step of S streams: a
    round carries B >= 1 new frames a stream, so one new frame a camera
    (phovo-serve --chunk 1, a fleet of live cameras) is one pair a stream
    and the level kernel runs at B = S. Where the round is a chain of
    launches with no host synchronisation (round_capturable: on one CUDA
    card, zero-init level-major, one camera, frames K-PREP takes), it
    replays one CUDA graph of the whole round (RoundGraph), captured once
    per key, instead of dispatching its launches one by one.

align_sequences_levelmajor, align_sequences and serve_sequences_chunk
each open a phovo.align span (utils/profiling.span), as the chunked
entries do; nested, the time counts to the inner one, so a round's glue
(the stacking, the per-level slices, _gather, the pose integration) lies
in phovo.align, its conversions and packs in phovo.prep and its level
launches in phovo.level; a replayed round's launches lie in phovo.replay,
inside the one phovo.align.

Intrinsics: one Intrinsics for a shared rig, or a list of S (one per
stream or pair). The kernels take the intrinsics as scalar arguments, so
the streams are grouped by camera and each group runs its own level-major
batch; zero-init pairs are independent, so this gives what phovo_tpu's
vmap over (S,) intrinsic vectors gives.

The mesh forms (make_data_parallel_aligner,
align_sequences_levelmajor_sharded, make_multi_sequence_server,
make_chunked_sequence_server) shard pairs or streams over the mesh's data
axis (parallel/mesh.py): every rank takes the global inputs, runs its
shard through the single-device entries above on its card (the level
kernel at B = its pairs), and the shards are gathered back whole on every
rank. A pair's result on the card does not depend on its batch, so there
a data-axis form gives the unsharded call's bits; on the CPU the plain
versions' batched sums round with the batch (~1e-7). The servers integrate
the poses from the gathered states: the card's batched 4x4 products round
with the batch count.
"""

from __future__ import annotations

import threading

import torch

from phovo_tpu_torch.models import analytic, base
from phovo_tpu_torch.models.analytic import (
    _fused_route,
    align_analytic,
    align_batch_fused,
    align_pairs_levelmajor,
    align_sequence,
    align_sequence_chunk,
    multi_kernel_eligible,
    prep_frame_analytic,
    prep_frame_targets,
)
from phovo_tpu_torch.models.base import AlignmentResult, CallGraph
from phovo_tpu_torch.ops import fused_batch, se3
from phovo_tpu_torch.ops.camera import Intrinsics
from phovo_tpu_torch.ops.prep import chunk_device_prep, device_unit_intensity, frames_take_kernel
from phovo_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, gather
from phovo_tpu_torch.utils import profiling
from phovo_tpu_torch.utils.config import PhovoConfig


def _cameras(intr, n: int) -> list[Intrinsics]:
    """The intrinsics of each of n items: a shared Intrinsics or a list of
    n."""
    if isinstance(intr, Intrinsics):
        return [intr] * n
    cams = [Intrinsics(*map(float, c)) for c in intr]
    if len(cams) != n:
        raise ValueError(f"{len(cams)} intrinsics for {n} streams")
    return cams


def _camera_groups(intr, n: int) -> list[tuple[Intrinsics, list[int]]]:
    """[(intrinsics, indices)] of n items, one group per distinct camera in
    first-seen order."""
    groups: dict[Intrinsics, list[int]] = {}
    for k, cam in enumerate(_cameras(intr, n)):
        groups.setdefault(cam, []).append(k)
    return list(groups.items())


def _select(x: torch.Tensor, idx: list[int]) -> torch.Tensor:
    """x[idx] along dim 0, x itself when idx is every item in order."""
    if idx == list(range(x.shape[0])):
        return x
    return x[torch.tensor(idx, device=x.device)]


def _gather(parts, n: int, dim: int = 0) -> AlignmentResult:
    """[(indices, AlignmentResult)] -> one AlignmentResult of n items in
    index order along dim."""
    if len(parts) == 1:
        return parts[0][1]
    order = torch.tensor([k for idx, _ in parts for k in idx])
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n)
    fields = zip(*(res for _, res in parts))
    return AlignmentResult(*(
        torch.cat(f, dim=dim).index_select(dim, inv.to(f[0].device)) for f in fields
    ))


def align_batch(
    source_intensity: torch.Tensor,  # (B, H, W) uint8 or float32 0..1
    source_depth: torch.Tensor,  # (B, H, W) metres
    target_intensity: torch.Tensor,  # (B, H, W)
    target_depth: torch.Tensor,  # unused (the reference SetTargetFrame ignores depth)
    intr,  # Intrinsics (shared) or a list of B
    init_states: torch.Tensor,  # (B, 6)
    config: PhovoConfig,
    use_fused: bool = False,
) -> AlignmentResult:
    """B independent alignments from per-pair inits (phovo_tpu/parallel/
    batch.py::align_batch, the vmap of align_analytic). On the level
    kernel's route (use_fused, gradient_at 'warped' or 'esm') each frame is
    prepped once (prep_frame_analytic of the sources and the targets) and
    every active level is ONE launch at B pairs; the per-pair loop makes
    pair b's result the bits of align_analytic on pair b alone (on the
    card; the plain version's batched sums may round otherwise). Otherwise
    the pairs run one after the other through align_analytic's exact torch
    path. Returns batched results (leading dim B)."""
    B = source_intensity.shape[0]
    if not _fused_route(config, use_fused):
        results = [
            align_analytic(source_intensity[b], source_depth[b], target_intensity[b],
                           target_depth[b], cam, init_states[b], config, use_fused)
            for b, cam in enumerate(_cameras(intr, B))
        ]
        return AlignmentResult(*(torch.stack(x) for x in zip(*results)))
    si = device_unit_intensity(source_intensity).to(torch.float32).contiguous()
    ti = device_unit_intensity(target_intensity).to(torch.float32)
    sd = source_depth.to(device=si.device, dtype=torch.float32)
    init = init_states.to(device=si.device, dtype=torch.float32).reshape(B, 6)
    shape = tuple(si.shape[1:])
    parts = []
    for cam, idx in _camera_groups(intr, B):
        src = prep_frame_analytic(_select(si, idx), _select(sd, idx), cam, config)
        tgt = prep_frame_targets(_select(ti, idx), config)
        packs = {level: (i0, geom, tgt[level]) for level, (i0, geom, _) in src.items()}
        parts.append((idx, align_pairs_levelmajor(packs, shape, cam, config, _select(init, idx))))
    return _gather(parts, B)


def align_sequences_levelmajor(
    intensities: torch.Tensor,  # (S, T, H, W)
    depths: torch.Tensor,  # (S, T, H, W) metres
    intr: Intrinsics,  # shared by the streams
    config: PhovoConfig,
) -> AlignmentResult:
    """All S streams' T-1 zero-init pairs as ONE level-major batch
    (phovo_tpu/parallel/batch.py::align_sequences_levelmajor): every frame
    prepped once, each interior frame the target of one pair and the source
    of the next, then one launch per active level for all S (T-1) pairs.
    Returns results with leading dims (S, T-1)."""
    with profiling.span("phovo.align"):
        S, T = intensities.shape[:2]
        shape = tuple(intensities.shape[2:])
        flat_i = device_unit_intensity(intensities).to(torch.float32).reshape(S * T, *shape)
        flat_d = depths.to(device=flat_i.device, dtype=torch.float32).reshape(S * T, *shape)
        prep = prep_frame_analytic(flat_i, flat_d, intr, config)
        B = S * (T - 1)
        pairs = {}
        for level, (i0, geom, t_all) in prep.items():
            # at T = 2 (one new frame a stream) each slice is a strided view
            # of every other frame; above it reshape copies already
            i0s = i0.reshape(S, T, -1)[:, :-1].reshape(B, -1).contiguous()
            geoms = geom.reshape(S, T, *geom.shape[1:])[:, :-1].reshape(B, *geom.shape[1:]).contiguous()
            ts = t_all.reshape(S, T, *t_all.shape[1:])[:, 1:].reshape(B, *t_all.shape[1:]).contiguous()
            pairs[level] = (i0s, geoms, ts)
        res = align_pairs_levelmajor(pairs, shape, intr, config)
        return AlignmentResult(*(x.reshape(S, T - 1, *x.shape[1:]) for x in res))


def align_sequences(
    intensities: torch.Tensor,  # (S, T, H, W) S independent camera streams
    depths: torch.Tensor,  # (S, T, H, W)
    intr,  # Intrinsics (shared rig) or a list of S (one per camera)
    config: PhovoConfig,
    use_fused: bool = True,
    warm_start: bool = False,
) -> tuple[AlignmentResult, torch.Tensor]:
    """Align S independent frame sequences (phovo_tpu/parallel/batch.py::
    align_sequences). Zero-init streams on the level kernel's route are
    flattened, per camera, into one level-major batch
    (align_sequences_levelmajor); every other stream runs as the port's
    align_sequence (the serial warm chain, or the exact path pair after
    pair). Each stream's results are then its own align_sequence's.
    Returns (results with leading dims (S, T-1), global poses (S, T-1, 4,
    4) integrated per stream from the identity)."""
    with profiling.span("phovo.align"):
        S = intensities.shape[0]
        parts = []
        for cam, idx in _camera_groups(intr, S):
            if not warm_start and _fused_route(config, use_fused):
                parts.append((idx, align_sequences_levelmajor(_select(intensities, idx), _select(depths, idx), cam,
                                                              config)))
                continue
            runs = [align_sequence(intensities[s], depths[s], cam, config, use_fused, warm_start) for s in idx]
            parts.append((idx, AlignmentResult(*(torch.stack(x) for x in zip(*runs)))))
        res = _gather(parts, S)
        return res, se3.integrate_trajectory(res.state)


def align_sequences_multi(
    intensities: torch.Tensor,  # (S, T, H, W) S independent camera streams
    depths: torch.Tensor,  # (S, T, H, W) metres
    intr: Intrinsics,  # shared by the streams
    config: PhovoConfig,
    warm_start: bool = False,
) -> tuple[AlignmentResult, torch.Tensor]:
    """align_sequences through the multi-stream level (phovo_tpu/parallel/
    batch.py::align_sequences_multi): a loop over time, each step aligning
    all S streams' pairs (t, t+1) with ONE align_batch_fused, one launch
    per active level; warm_start starts each stream's pair from the state
    its pair before ended at. 'tdist' raises ValueError (no multi-stream
    level). Returns (results with leading dims (S, T-1), global poses (S,
    T-1, 4, 4))."""
    S, T = intensities.shape[:2]
    init = torch.zeros((S, 6), dtype=torch.float32, device=intensities.device)
    steps = []
    for t in range(T - 1):
        res = align_batch_fused(
            intensities[:, t], depths[:, t], intensities[:, t + 1], depths[:, t + 1],
            intr, init, config,
        )
        steps.append(res)
        if warm_start:
            init = res.state
    res = AlignmentResult(*(torch.stack(x, dim=1) for x in zip(*steps)))
    return res, se3.integrate_trajectory(res.state)


def round_capturable(carry_intensity, carry_depth, intensities, depths, intr, config: PhovoConfig,
                     use_fused: bool = True, warm_start: bool = False, depth_scale: float | None = None) -> bool:
    """Whether serve_sequences_chunk's round over these tensors is a chain
    of launches with no host synchronisation that one CUDA graph can
    replay (RoundGraph): (S, B, H, W) new frames, not empty, every tensor
    on one card; the zero-init level-major route (no warm_start, the level
    kernel's route) through the K-GN wrapper itself (a plain version put in
    its place, as a comparison does, runs launch by launch); one camera
    for every stream (several cameras index their groups on the host); and
    frames K-PREP takes in these dtypes on a CUDA card
    (frames_take_kernel: blurred presets run the torch chain)."""
    dev = intensities.device
    return (intensities.dim() == 4 and intensities.numel() > 0
            and all(t.device == dev for t in (carry_intensity, carry_depth, depths))
            and not warm_start and _fused_route(config, use_fused)
            and analytic.fused_gn_level_batch is fused_batch.fused_gn_level_batch
            and len(_camera_groups(intr, intensities.shape[0])) == 1
            and frames_take_kernel(config, tuple(intensities.shape[-2:]), dev,
                                   (carry_intensity.dtype, intensities.dtype), (carry_depth.dtype, depths.dtype),
                                   depth_scale))


class RoundGraph(CallGraph):
    """serve_sequences_chunk's round as a CUDA graph (models/base.CallGraph):
    the per-stream conversions and carry prepends, the stacks, K-PREP, the
    level slices, the K-GN levels and their glue, the result's reshape and
    the pose integration, over static buffers for the carries and the new
    frames. The key is the config, the camera, depth_scale and each
    input's shape, dtype and device. The result comes back in two
    groups, the results with the poses and the new carries, so a caller
    that keeps a round's results (phovo-serve keeps its states while it
    dispatches the next round) holds none of the carries' memory."""

    SLOTS = ("carry intensity", "carry depth", "intensities", "depths")

    def flatten(self, out) -> list[list[torch.Tensor]]:
        res, poses, carry_i, carry_d = out
        return [[*res, poses], [carry_i, carry_d]]

    def unflatten(self, tensors: list[torch.Tensor]):
        return AlignmentResult(*tensors[:6]), *tensors[6:]

    def count(self, replay: bool) -> None:
        if replay:
            base.ROUND_GRAPH_REPLAYS += 1
        else:
            base.ROUND_GRAPH_CAPTURES += 1


# The round graph of this process: one key at a time (a new key captures
# anew), one round at a time.
_ROUND_GRAPH = RoundGraph()
_ROUND_LOCK = threading.Lock()


def _serve_round(carry_intensity, carry_depth, intensities, depths, intr, config, use_fused, warm_start,
                 depth_scale):
    """One round, launch by launch: serve_sequences_chunk's work."""
    prepped = [
        chunk_device_prep(ci, cd, I, D, depth_scale)
        for ci, cd, I, D in zip(carry_intensity, carry_depth, intensities, depths)
    ]
    I = torch.stack([p[0] for p in prepped])
    D = torch.stack([p[1] for p in prepped])
    res, poses = align_sequences(I, D, intr, config, use_fused, warm_start)
    return res, poses, I[:, -1], D[:, -1]


def serve_sequences_chunk(
    carry_intensity: torch.Tensor,  # (S, H, W) each stream's last frame of the chunk before
    carry_depth: torch.Tensor,  # (S, H, W) metres
    intensities: torch.Tensor,  # (S, B, H, W) new frames, uint8 or float32
    depths: torch.Tensor,  # (S, B, H, W) metres float32, or raw counts
    intr,  # Intrinsics (shared rig) or a list of S
    config: PhovoConfig,
    use_fused: bool = True,
    warm_start: bool = False,
    depth_scale: float | None = None,
) -> tuple[AlignmentResult, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One streaming step of S streams, B >= 1 new frames each (phovo_tpu/
    parallel/batch.py::serve_sequences_chunk): per stream the storage
    dtypes are converted and its carry frame prepended on the device
    (chunk_device_prep), then align_sequences. Returns (results with
    leading dims (S, B), chunk-relative poses (S, B, 4, 4): pair k's pose
    relative to the stream's chunk-start frame, the new carry intensities
    (S, H, W) and depths, float32).

    Where round_capturable holds for the call, the round replays this
    process's RoundGraph: a new key runs eagerly and captures, the same key
    copies the carries and the new frames into the graph's buffers and
    replays it, with the eager round's bits. No returned tensor changes
    with a later call."""
    with profiling.span("phovo.align"):
        inputs = (carry_intensity, carry_depth, intensities, depths)

        def round_(*x):
            return _serve_round(*x, intr, config, use_fused, warm_start, depth_scale)

        if not round_capturable(*inputs, intr, config, use_fused, warm_start, depth_scale):
            return round_(*inputs)
        camera = _cameras(intr, intensities.shape[0])[0]
        key = (config, camera, depth_scale, tuple((t.shape, t.dtype, t.device) for t in inputs))
        with _ROUND_LOCK:
            return _ROUND_GRAPH.run(round_, inputs, key)


# -- the mesh forms: pairs and streams over the data axis ---------------------


def _stream_shard(mesh: Mesh, S: int) -> tuple[int, int]:
    """[start, stop) of this rank's streams of S; S must be divisible by the
    data axis (phovo_tpu's rule)."""
    n_data = mesh.shape[DATA_AXIS]
    if S % n_data:
        raise ValueError(f"S={S} not divisible by data axis {n_data}")
    per = S // n_data
    lo = mesh.index(DATA_AXIS) * per
    return lo, lo + per


def _shard_cameras(intr, lo: int, hi: int):
    """The intrinsics of items [lo, hi): a shared Intrinsics, or that slice
    of a list."""
    return intr if isinstance(intr, Intrinsics) else list(intr)[lo:hi]


def make_data_parallel_aligner(mesh: Mesh, config: PhovoConfig, use_fused: bool = False):
    """align(si, sd, ti, td, intr, init_states) over (B, H, W) pairs with the
    batch sharded over the mesh's data axis: each rank aligns its
    B / data pairs with align_batch, and the results are gathered whole on
    every rank (phovo_tpu/parallel/batch.py::make_data_parallel_aligner). A
    B the data axis does not divide is padded by repeating the last pair
    (a padded pair aligns on its own, so the real pairs' results are the
    divisible case's) and the results are cut back to B."""
    n_data = mesh.shape[DATA_AXIS]

    def align(si, sd, ti, td, intr, init_states) -> AlignmentResult:
        B = si.shape[0]
        pad = (-B) % n_data
        cams = _cameras(intr, B)
        if pad:
            def rep(a):
                return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])

            si, sd, ti, td, init_states = (rep(a) for a in (si, sd, ti, td, init_states))
            cams = cams + cams[-1:] * pad
        per = (B + pad) // n_data
        lo = mesh.index(DATA_AXIS) * per
        shard_intr = intr if isinstance(intr, Intrinsics) else cams[lo:lo + per]
        sl = slice(lo, lo + per)
        res = align_batch(si[sl], sd[sl], ti[sl], td[sl], shard_intr, init_states[sl], config, use_fused)
        res = gather(mesh, res, B + pad, lo)
        return AlignmentResult(*(x[:B] if isinstance(x, torch.Tensor) else x for x in res))

    return align


def align_sequences_levelmajor_sharded(
    intensities: torch.Tensor,  # (S, T, H, W)
    depths: torch.Tensor,  # (S, T, H, W) metres
    intr: Intrinsics,  # shared by the streams
    config: PhovoConfig,
    mesh: Mesh,
) -> AlignmentResult:
    """align_sequences_levelmajor with the S streams sharded over the mesh's
    data axis: each rank flattens ITS streams' pairs into one local
    level-major batch (phovo_tpu/parallel/batch.py::
    align_sequences_levelmajor_sharded). S must be divisible by the data
    axis. Returns results with leading dims (S, T-1), whole on every
    rank."""
    lo, hi = _stream_shard(mesh, intensities.shape[0])
    res = align_sequences_levelmajor(intensities[lo:hi], depths[lo:hi], intr, config)
    return gather(mesh, res, intensities.shape[0], lo)


def make_multi_sequence_server(mesh: Mesh, config: PhovoConfig, use_fused: bool = True, warm_start: bool = False):
    """serve(intensities (S, T, H, W), depths, intr) -> (results (S, T-1,
    ...), global poses (S, T-1, 4, 4)) with the S camera streams sharded
    over the mesh's data axis (phovo_tpu/parallel/batch.py::
    make_multi_sequence_server): each rank serves its streams through
    align_sequences_multi (one multi-stream launch a level a time step,
    phovo_tpu's B7) where that route takes the config (the level kernel's
    route, no 'tdist', a shared rig), else through align_sequences. S must
    be divisible by the data axis."""

    def serve(intensities, depths, intr):
        S = intensities.shape[0]
        lo, hi = _stream_shard(mesh, S)
        I, D = intensities[lo:hi], depths[lo:hi]
        if isinstance(intr, Intrinsics) and _fused_route(config, use_fused) and multi_kernel_eligible(config):
            res, _ = align_sequences_multi(I, D, intr, config, warm_start)
        else:
            res, _ = align_sequences(I, D, _shard_cameras(intr, lo, hi), config, use_fused, warm_start)
        res = gather(mesh, res, S, lo)
        return res, se3.integrate_trajectory(res.state)

    return serve


def make_chunked_sequence_server(
    mesh: Mesh,
    config: PhovoConfig,
    use_fused: bool = True,
    warm_start: bool = False,
    depth_scale: float | None = None,
    levelmajor: str = "auto",
):
    """serve(carry_i (S, H, W), carry_d, intensities (S, B, H, W), depths,
    intr) -> (results (S, B, ...), chunk-relative poses (S, B, 4, 4), new
    carry intensities, new carry depths): the streaming server with the S
    streams sharded over the mesh's data axis (phovo_tpu/parallel/batch.py::
    make_chunked_sequence_server), frames in their storage dtypes,
    converted on the card. levelmajor 'auto' serves each rank's streams
    with serve_sequences_chunk (their zero-init pairs flattened into one
    level-major batch where eligible); 'off' runs each stream's own chunked
    chain (align_sequence_chunk); 'interpret' is taken as 'auto' (phovo_tpu's
    interpret-mode kernels have no counterpart), as run_chunked takes it.
    S must be divisible by the data axis."""
    if levelmajor not in ("auto", "off", "interpret"):
        raise ValueError(f"levelmajor={levelmajor!r}; expected 'auto', 'off' or 'interpret'")

    def serve(carry_i, carry_d, intensities, depths, intr):
        S = intensities.shape[0]
        lo, hi = _stream_shard(mesh, S)
        cams = _shard_cameras(intr, lo, hi)
        args = (carry_i[lo:hi], carry_d[lo:hi], intensities[lo:hi], depths[lo:hi])
        if levelmajor == "off":
            runs = [align_sequence_chunk(*a, cam, config, use_fused, warm_start, depth_scale)
                    for *a, cam in zip(*args, _cameras(cams, hi - lo))]
            res = AlignmentResult(*(torch.stack(x) for x in zip(*(r[0] for r in runs))))
            carry_i, carry_d = torch.stack([r[1] for r in runs]), torch.stack([r[2] for r in runs])
        else:
            res, _, carry_i, carry_d = serve_sequences_chunk(*args, cams, config, use_fused, warm_start, depth_scale)
        res, carry_i, carry_d = (gather(mesh, x, S, lo) for x in (res, carry_i, carry_d))
        return res, se3.integrate_trajectory(res.state), carry_i, carry_d

    return serve
