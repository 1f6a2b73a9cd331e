"""The device mesh over torch.distributed (torch port of
phovo_tpu/parallel/mesh.py).

phovo_tpu's mesh is single-controller: one process sees every device, and
a jitted call takes global arrays and returns sharded or replicated ones.
The port runs one process a card (torchrun, or ranks spawned on one host),
and a Mesh is this process's view of the grid of ranks:

  axis "data"  - frame pairs and camera streams (parallel/batch.py's
                 forms): each rank aligns its shard, no traffic but the
                 gather of the results;
  axis "pixel" - image rows of one frame (parallel/sharded_ne.py): one
                 all_reduce of the 6x6 normal equations a linearization;
  both, flattened - pose-graph edges and bundle-adjustment observations:
                 one all_reduce of the blocks a Gauss-Newton or LM step.

Ranks are laid out data-major: rank r has coordinates (r // pixel,
r % pixel). A mesh of n devices takes ranks 0..n-1 of the world; a rank
past them holds a Mesh outside it (rank None), which no form accepts.

Calling convention: every rank of the mesh calls a form with the same
global inputs, computes its shard, and gets the whole result back, equal
on every rank. The collectives are all_reduce only, the one collective
gloo runs on CUDA tensors besides broadcast and barrier, so one code path
serves NCCL on several cards and gloo on one card or the CPU: a psum is an
all_reduce; a gather of data-axis shards is an all_reduce of a zero-filled
global buffer holding this rank's rows, which adds exact zeros to every
other rank's rows, so the gathered rows are the shards' own values. An
axis of size 1 makes no collective: a one-rank mesh runs the unsharded
code and gives its bits.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

DATA_AXIS = "data"
PIXEL_AXIS = "pixel"
AXES = (DATA_AXIS, PIXEL_AXIS)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a (data, pixel) grid of ranks."""

    shape: dict  # {"data": D, "pixel": P}
    rank: int | None  # this process's index in the mesh, None outside it
    device: torch.device  # this rank's card
    groups: dict  # frozenset of axis names -> process group; {} with no process group

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[PIXEL_AXIS]

    @property
    def coords(self) -> tuple[int, int]:
        """This rank's (data, pixel) coordinates; ValueError outside the
        mesh."""
        if self.rank is None:
            raise ValueError(f"this rank is outside the mesh of {self.size} devices")
        return divmod(self.rank, self.shape[PIXEL_AXIS])

    @property
    def flat_index(self) -> int:
        """This rank's index over both axes flattened (data-major)."""
        d, p = self.coords
        return d * self.shape[PIXEL_AXIS] + p

    def index(self, axis: str) -> int:
        return self.coords[AXES.index(axis)]

    def axis_size(self, axes) -> int:
        n = 1
        for a in _axes(axes):
            n *= self.shape[a]
        return n


def _axes(axes) -> frozenset:
    return frozenset([axes] if isinstance(axes, str) else axes)


def world() -> tuple[int, int]:
    """(world size, rank) of torch.distributed's default group; (1, 0)
    with none initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def default_device(rank: int) -> torch.device:
    """A rank's card: LOCAL_RANK (torchrun's), else the rank, modulo the
    cards torch sees."""
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def make_mesh(n_devices: int | None = None, pixel_parallel: int = 1, devices=None) -> Mesh:
    """Mesh of shape (n_devices // pixel_parallel, pixel_parallel) over
    ranks 0..n_devices-1 of torch.distributed's default group (default: all
    of them). Every rank of the group must call it, in the same order as
    its other make_mesh calls: each axis's process subgroups are built
    here, once. With no process group initialized the only mesh is
    n_devices=1, which runs the single-device code unchanged. devices: one
    torch device a mesh rank (default: each rank's card,
    default_device)."""
    n_world, rank = world()
    if n_devices is None:
        n_devices = n_world
    if n_devices % pixel_parallel != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by pixel_parallel={pixel_parallel}")
    if not 1 <= n_devices <= n_world:
        if n_world == 1:
            raise ValueError(
                f"a mesh of {n_devices} devices needs {n_devices} ranks of torch.distributed and this process has "
                f"none initialized (world size 1); start the ranks with torchrun or initialize()"
            )
        raise ValueError(f"a mesh of {n_devices} devices needs {n_devices} ranks; the world size is {n_world}")
    n_data = n_devices // pixel_parallel
    groups = {}
    if n_world > 1:
        def build(key, members):
            group = dist.new_group(members)
            if rank in members:
                groups[key] = group

        build(frozenset(AXES), list(range(n_devices)))
        for p in range(pixel_parallel):
            build(frozenset([DATA_AXIS]), [d * pixel_parallel + p for d in range(n_data)])
        for d in range(n_data):
            build(frozenset([PIXEL_AXIS]), [d * pixel_parallel + p for p in range(pixel_parallel)])
    inside = rank < n_devices
    device = torch.device(devices[rank]) if devices is not None and inside else default_device(rank)
    return Mesh({DATA_AXIS: n_data, PIXEL_AXIS: pixel_parallel}, rank if inside else None, device, groups)


def psum(mesh: Mesh | None, tensors, axes=AXES):
    """The sum over the mesh axes `axes` of a tensor, or of a sequence of
    tensors of one dtype in ONE all_reduce (returned as a tuple); the input
    itself without a mesh or where those axes hold one rank."""
    if mesh is None or mesh.axis_size(axes) == 1:
        return tensors
    single = isinstance(tensors, torch.Tensor)
    parts = [tensors] if single else list(tensors)
    flat = torch.cat([t.reshape(-1) for t in parts])
    dist.all_reduce(flat, group=mesh.groups[_axes(axes)])
    out, at = [], 0
    for t in parts:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out[0] if single else tuple(out)


def shard_bounds(n: int, shards: int, index: int) -> tuple[int, int]:
    """[start, stop) of shard `index` of n items split into `shards` equal
    slices of ceil(n / shards) (phovo_tpu pads n to a multiple and shards
    evenly; the padding rows are the slices' missing tail)."""
    per = -(-n // shards)
    lo = min(n, index * per)
    return lo, min(n, lo + per)


def gather(mesh: Mesh, local, n: int, start: int, axes=(DATA_AXIS,)):
    """The (n, ...) tensors whose rows [start, start + len) are `local` on
    each rank of the mesh axes `axes` (a tensor, or a tuple or NamedTuple
    of them; other fields pass through): one all_reduce a tensor of a
    zero-filled global buffer. Where the axes hold one rank, `local`
    itself (it is then every row)."""
    if mesh.axis_size(axes) == 1:
        return local
    if not isinstance(local, torch.Tensor):
        fields = [gather(mesh, x, n, start, axes) if isinstance(x, torch.Tensor) else x for x in local]
        return type(local)(*fields) if hasattr(local, "_fields") else type(local)(fields)
    buf = local.new_zeros((n, *local.shape[1:]))
    buf[start:start + local.shape[0]] = local
    dist.all_reduce(buf, group=mesh.groups[_axes(axes)])
    return buf
