"""The (data, model) mesh over ``torch.distributed``.

Counterpart of ``midi_model_tpu/parallel/mesh.py`` for serving.  There is
no global sharded array and no single controller: one process per rank,
each holding its shard as ordinary local tensors, every rank running the
same host program over the same requests (SPMD).

- Ranks are laid out ``[dp, tp]`` row-major, as the JAX package's device
  grid: rank ``r`` is data shard ``r // tp`` and model shard ``r % tp``.
- The **model** group (the ranks of one data shard) carries the
  Megatron all-reduces: two per event-net layer, in the activation's dtype
  (:func:`all_reduce_sum`).
- The **data** group (the ranks of one model shard) carries nothing in the
  decode loop: each data shard decodes its own rows or slots alone.  In
  training it sums the gradients once a step and the loss's pad counts
  once a microbatch (``train.trainer``).
- The **host** group, gloo over the mesh's ranks, carries host objects:
  the rows each data shard decoded (:func:`gather_shards`).

Between GPUs the default group is NCCL; on the CPU, and for several ranks
on one GPU (NCCL refuses two ranks on one device), it is gloo, which
all-reduces CUDA tensors through the host.  :func:`spawn` starts the ranks
of one host as processes.  The autograd forms of the model group's
collectives are in ``parallel.collectives``.

Training feeds each data shard its own slice of the corpus
(:func:`data_shard`).  The JAX package's ``host_local_batch_to_global``
has no counterpart: there is no global array to assemble, each rank's
batch is its data shard's rows.
"""

from __future__ import annotations

import datetime
import os
import signal
import socket
import traceback
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a ``(data, model)`` mesh.  The groups are None
    when the mesh is one rank without a process group."""

    dp: int
    tp: int
    data_rank: int  # this rank's data shard
    model_rank: int  # this rank's model shard
    data_group: Optional[dist.ProcessGroup]  # the ranks of this model shard
    model_group: Optional[dist.ProcessGroup]  # the ranks of this data shard
    host_group: Optional[dist.ProcessGroup]  # gloo over the mesh's ranks
    device: torch.device

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.tp}


def make_mesh(dp: Optional[int] = None, tp: int = 1, device=None) -> Optional[Mesh]:
    """This rank's ``(data, model)`` mesh over the initialized default
    process group, or over one rank when there is none.  ``dp`` defaults to
    world // tp.  A mesh smaller than the world takes its first ``dp * tp``
    ranks (as the JAX package's takes the first devices); the other ranks
    get None.  Every rank calls it, in the same order (it creates the
    groups).  ``device`` defaults to the card ``cuda:(rank %
    device_count)``; the CPU only when named.  A card becomes the process's
    current device: the kernels launch on the current device, and
    ``"cuda"`` names it."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if dp is None:
        if world % tp:
            raise ValueError(f"world size {world} not divisible by tp={tp}")
        dp = world // tp
    if dp * tp > world:
        raise ValueError(f"dp={dp} x tp={tp} exceeds the world size {world}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "port's plain versions on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    data_rank, model_rank = divmod(rank, tp)
    groups = dict(data_group=None, model_group=None, host_group=None)
    if initialized:
        # every rank creates every group, in the same order
        for d in range(dp):
            group = dist.new_group([d * tp + m for m in range(tp)])
            if d == data_rank:
                groups["model_group"] = group
        for m in range(tp):
            group = dist.new_group([d * tp + m for d in range(dp)])
            if m == model_rank:
                groups["data_group"] = group
        groups["host_group"] = dist.new_group(list(range(dp * tp)), backend="gloo")
    if rank >= dp * tp:
        return None
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(dp=dp, tp=tp, data_rank=data_rank, model_rank=model_rank,
                device=device, **groups)


def all_reduce_sum(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """``x`` summed over ``group``, in place and in ``x``'s dtype (the JAX
    package's ``psum``); ``x`` itself, untouched, without a group or on a
    group of one."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def gather_shards(mesh: Mesh, local: np.ndarray) -> np.ndarray:
    """Each data shard's ``local`` (the same shape and dtype on every rank),
    concatenated along axis 0 in data order, on every rank.  The model
    shards of a data shard hold the same array; the first one's is taken."""
    if mesh.host_group is None:
        return local
    world = mesh.dp * mesh.tp
    mine = torch.from_numpy(np.ascontiguousarray(local))
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine, group=mesh.host_group)
    return np.concatenate([parts[d * mesh.tp].numpy() for d in range(mesh.dp)])


def process_shard(seq: Sequence) -> list:
    """This process's shard of a list: ``seq[rank::world]`` (one rank
    without a process group: all of it)."""
    initialized = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if initialized else 0
    world = dist.get_world_size() if initialized else 1
    return list(seq)[rank::world]


def data_shard(seq: Sequence, mesh: Optional[Mesh]) -> list:
    """This rank's data shard of a list, ``seq[data_rank::dp]``: the model
    shards of one data shard get the same items (the whole list without a
    mesh).  Training shards its file list so; :func:`process_shard`, by
    global rank, would feed the model shards of one data shard different
    rows."""
    if mesh is None:
        return list(seq)
    return list(seq)[mesh.data_rank::mesh.dp]


def _free_port() -> int:
    """A TCP port on the loopback interface that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, init_method: str, backend: str,
               init_timeout_s: float, args: tuple) -> None:
    try:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=init_timeout_s))
        try:
            fn(*args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        raise


def spawn(fn: Callable, world: int, args: tuple = (), *, backend: str = "gloo",
          timeout_s: Optional[float] = 600.0, init_timeout_s: float = 120.0,
          daemon: bool = True, forward_signals: bool = False) -> None:
    """Run ``fn(*args)`` in ``world`` spawned processes, ranks of one
    process group (``backend``, over a free loopback port; its collectives
    time out after ``init_timeout_s``), and wait at most ``timeout_s`` for
    them all (None: no limit but the collectives').  ``fn`` must be
    importable by name.  Raises if a rank fails or is still running at the
    limit (every rank is then killed).  ``daemon=False`` lets a rank start
    processes of its own (a data loader's workers); ``forward_signals``
    hands SIGTERM and SIGINT to the ranks while they run, and waits for
    them, instead of stopping this process."""
    ctx = torch.multiprocessing.get_context("spawn")
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=daemon,
                         args=(fn, rank, world, init_method, backend, init_timeout_s, args))
             for rank in range(world)]
    for p in procs:
        p.start()
    previous = {}
    if forward_signals:
        def forward(signum, frame):
            for p in procs:
                if p.is_alive():
                    os.kill(p.pid, signum)

        previous = {sig: signal.signal(sig, forward) for sig in (signal.SIGTERM, signal.SIGINT)}
    deadline = (None if timeout_s is None
                else datetime.datetime.now() + datetime.timedelta(seconds=timeout_s))
    try:
        for p in procs:
            p.join(None if deadline is None
                   else max(0.0, (deadline - datetime.datetime.now()).total_seconds()))
            if p.exitcode not in (0, None):
                break  # a failed rank leaves the others waiting on it
        hung = [r for r, p in enumerate(procs) if p.exitcode is None]
        failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode not in (0, None)}
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    if failed:
        raise RuntimeError(f"ranks failed (rank: exit code): {failed}")
    if hung:
        raise TimeoutError(f"ranks {hung} still running after {timeout_s} s")
