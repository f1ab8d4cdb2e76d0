"""The process group of a multi-process run, each rank's share of the data,
and gathering per-rank results.

Counterpart of ``ultra_tpu/parallel/multihost.py`` on ``torch.distributed``.
Each process is one rank and drives one device: ``cuda:(local rank %
device count)``, or the CPU when the caller asks for it.

- :func:`initialize` joins the group; :func:`initialize_from_env`, which
  the command lines call, gives it ``ULTRA_DIST``'s three fields or
  torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``, ``LOCAL_RANK``).
- :func:`shard_indices` gives a rank its samples of an epoch, with
  ``DistributedSampler``'s semantics: a copy of the JAX package's function,
  bit for bit.
- :func:`gather_ranks` concatenates per-rank result vectors on every rank.

The JAX package's ``host_local_batch_to_global`` has no counterpart: a JAX
process lifts its rows into one array sharded over every device of the
mesh, while a rank here is one device and keeps its own rows
(``parallel/dp.py`` takes them from the global batch).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join the process group at ``tcp://<coordinator_address>`` as rank
    ``process_id`` of ``num_processes``; without an address, from torchrun's
    environment, and with neither, nothing (one process). A no-op when a
    group exists.

    ``backend`` defaults to :func:`default_backend`'s."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        if "WORLD_SIZE" not in os.environ:
            return
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        num_processes, process_id = os.environ["WORLD_SIZE"], os.environ["RANK"]
    num_processes, process_id = int(num_processes), int(process_id)
    backend = backend or default_backend()
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    if "nccl" in backend:
        torch.cuda.set_device(local_device())


def default_backend() -> str:
    """``nccl`` for CUDA tensors (with ``gloo`` for the host tensors
    :func:`gather_ranks` moves) when every rank of this host has its own
    card, else ``gloo``, which also runs several ranks on one card.

    The ranks a host runs are ``LOCAL_WORLD_SIZE`` (torchrun sets it; set it
    by hand beside ``ULTRA_DIST`` to put several ranks on one card). Without
    it a host runs one rank a card, as a launch of one process per card
    does: the world size counts every host's ranks, so it says nothing of
    this one's."""
    if not torch.cuda.is_available():
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    return "cpu:gloo,cuda:nccl" if local <= torch.cuda.device_count() else "gloo"


def initialize_from_env(device="cuda") -> None:
    """What the command lines call first: :func:`initialize` from
    ``ULTRA_DIST="coordinator:port,num_processes,proc_id"`` when it is set
    (the JAX scripts' launch), else from torchrun's environment if any.
    ``device`` ``cpu`` takes the ``gloo`` backend. A malformed
    ``ULTRA_DIST`` raises ``ValueError``."""
    backend = "gloo" if torch.device(device).type == "cpu" else None
    value = os.environ.get("ULTRA_DIST")
    if not value:
        return initialize(backend=backend)
    fields = value.split(",")
    if len(fields) != 3 or not all(f.strip() for f in fields):
        raise ValueError(f"ULTRA_DIST={value!r}: want coordinator:port,num_processes,proc_id")
    initialize(fields[0], int(fields[1]), int(fields[2]), backend=backend)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    return process_index() == 0


def local_device() -> torch.device:
    """This rank's card: ``cuda:(local rank % device count)``, the local rank
    being torchrun's ``LOCAL_RANK`` or else the rank."""
    local_rank = int(os.environ.get("LOCAL_RANK", process_index()))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def rank_device(device) -> torch.device:
    """``device``, with a bare ``cuda`` read as this rank's card when a
    process group exists."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and dist.is_initialized():
        return local_device()
    return device


def per_process_rng(seed: int) -> np.random.Generator:
    """The rank-coupled generator of negative sampling and shuffling, as the
    reference's ``torch.manual_seed(seed + rank)`` (``run.py:234``)."""
    return np.random.default_rng(seed + process_index())


def shard_indices(
    num_samples: int,
    epoch: int,
    seed: int = 0,
    shuffle: bool = True,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
) -> np.ndarray:
    """This rank's sample indices for one epoch (``DistributedSampler``,
    ``run.py:32-34``): every rank draws the same epoch-seeded permutation,
    the list is padded by wrapping around so that every rank gets as many,
    and rank p takes the strided slice ``[p::P]``."""
    p = process_index() if process_id is None else process_id
    world = process_count() if num_processes is None else num_processes
    idx = np.arange(num_samples)
    if shuffle:
        idx = np.random.default_rng(seed + epoch).permutation(idx)
    total = -(-num_samples // world) * world
    if total > num_samples:
        idx = np.concatenate([idx, idx[: total - num_samples]])
    return idx[p::world]


_HOST_GROUP = []


def _host_group():
    """The group that carries host tensors: the default one when its backend
    takes them, else a gloo group over every rank, made on first use (every
    rank reaches it in the same collective call)."""
    if "gloo" in str(dist.get_backend()):
        return None
    if not _HOST_GROUP:
        _HOST_GROUP.append(dist.new_group(backend="gloo"))
    return _HOST_GROUP[0]


def gather_ranks(local: np.ndarray) -> np.ndarray:
    """Concatenate each rank's 1-D result vector (ranks, counts), in rank
    order; every rank returns the whole. The vectors may differ in length:
    each is padded to the longest, gathered on the host and trimmed. Replaces
    the reference's size exchange and zero-padded all_reduce
    (``run.py:155-186``)."""
    local = np.asarray(local)
    world = process_count()
    if world == 1:
        return local
    group = _host_group()
    size = torch.tensor([len(local)], dtype=torch.int64)
    sizes = [torch.zeros_like(size) for _ in range(world)]
    dist.all_gather(sizes, size, group=group)
    sizes = [int(s) for s in sizes]
    padded = torch.zeros(max(sizes), dtype=torch.from_numpy(local[:0]).dtype)
    padded[: len(local)] = torch.from_numpy(np.ascontiguousarray(local))
    out = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(out, padded, group=group)
    return np.concatenate([o[:s].numpy() for o, s in zip(out, sizes)])
