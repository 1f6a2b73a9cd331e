"""Process-group initialization and the global mesh (torch port of
phovo_tpu/parallel/distributed.py).

phovo_tpu initializes jax.distributed (one process a host, every device
visible to each); the port initializes torch.distributed, one process a
card. Tracking stays on each rank's card; only the pose graph's and the
bundle adjustments' reductions cross cards (parallel/mesh.py). A single
process skips initialization, so the same program runs on one card.

spawn_ranks starts ranks on this host (the tests' gloo ranks on the CPU,
two ranks sharing one card): nothing tells a process of a cluster, so
each is given its rendezvous, world size and rank.
"""

from __future__ import annotations

import multiprocessing
import os
import queue as queue_mod
import time
import traceback

import torch
import torch.distributed as dist

from phovo_tpu_torch.parallel.mesh import make_mesh, world


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> bool:
    """Initialize torch.distributed's default process group when running
    several processes: from the arguments (coordinator_address
    'host:port' or an init_method URL such as 'file:///path'), else from
    torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).
    A no-op for one process (no coordinator and num_processes None or 1,
    WORLD_SIZE unset or 1) and where a group already exists. backend
    defaults to 'nccl' where torch finds a CUDA card and 'gloo' on the
    CPU; 'gloo' on the card (several ranks sharing one card, which NCCL
    refuses) must be asked for. Returns True when it initialized a
    group."""
    if dist.is_initialized():
        return False
    n = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if coordinator_address is None and n == 1:
        return False
    rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method, world_size=n, rank=rank)
    return True


def global_mesh(pixel_parallel: int = 1):
    """Mesh over every rank of the world (call after initialize())."""
    return make_mesh(world()[0], pixel_parallel=pixel_parallel)


def local_batch_slice(global_batch: int, mesh=None) -> tuple[int, int]:
    """(start, size) of this process's shard of a batch sharded over the
    processes (phovo_tpu's rule: global_batch // processes each). With a
    mesh, over its data axis: ranks that share a data coordinate share the
    shard, and a rank outside the mesh gets none."""
    if mesh is None:
        n, idx = world()
    elif mesh.rank is None:
        return 0, 0
    else:
        n, idx = mesh.shape["data"], mesh.coords[0]
    per = global_batch // n
    return idx * per, per


def to_numpy(x):
    """x with every tensor moved to a numpy array (queues pickle numpy
    arrays by value)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(to_numpy, x))
    if isinstance(x, (list, tuple)):
        return type(x)(map(to_numpy, x))
    return x


def _rank_main(rank, world_size, backend, init_method, fn, args, results):
    try:
        torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
        try:
            out = to_numpy(fn(*args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(fn, world_size: int, init_method: str, args=(), backend: str = "gloo", timeout: float = 600.0):
    """Run fn(*args) in world_size processes spawned on this host, each
    rank of one process group (init_method: a rendezvous such as
    'file:///path/store' in a fresh directory), and return each rank's
    result in rank order, its tensors as numpy arrays. fn must be
    importable by name (the spawned processes import its module; keep
    that module's imports to torch). Raises RuntimeError with the rank's
    traceback if a rank fails or exits without a result."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, world_size, backend, init_method, fn, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    got, failure = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world_size and failure is None:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    failure = f"ranks {dead} exited with {[procs[r].exitcode for r in dead]} and no result"
                elif time.monotonic() > deadline:
                    failure = f"no result from every rank within {timeout} s"
                continue
            if ok:
                got[rank] = out
            else:  # the other ranks may wait on it in a collective: stop them all
                failure = f"rank {rank}:\n{out}"
    finally:
        for p in procs:
            p.join(timeout=60 if failure is None else 5)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(f"spawn_ranks: {failure}")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"spawn_ranks: exit codes {codes}")
    return [got[r] for r in range(world_size)]

