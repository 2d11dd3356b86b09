"""Devices and ranks (counterpart of ``hvrnet_tpu/parallel/mesh.py``).

The JAX package lays its devices out as one mesh and lets XLA insert the
collectives.  The port trains with one process per card, joined by
``torch.distributed``, and serves its inference scale-outs from one
process that holds an engine replica per device:

* ``make_mesh(n, device)``: the devices of an n-way split, the first n
  local cards, or ``["cpu"] * n``;
* ``init_distributed``: ``torch.distributed.init_process_group`` over
  ``tcp://<coordinator>``, NCCL for CUDA devices and gloo for the CPU
  unless a backend is named, then one collective, so that a backend that
  cannot start fails here; no other backend is ever tried;
* ``world_and_rank``: (world, rank) of the default process group, (1, 0)
  without one (a rank's slice of each step's samples is
  ``engine/stream.py:train_batch_iterator(world=, rank=)``);
* ``rank_seed``: rank r's sampler seed, ``seed + r·2³²``, so that rank 0
  draws what one process draws (the JAX loop splits its key into one per
  device, ``hvrnet_tpu/apis.py:153-158``);
* ``all_reduce_mean_`` / ``broadcast_``: the ``pmean`` of
  ``hvrnet_tpu/engine/train.py:181-184`` and a copy from rank 0, in place
  over a list of tensors, one flat buffer per dtype and device.
"""
from __future__ import annotations

import datetime
from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

# the process group's wait for a rank before a collective fails, s
TIMEOUT_S = 1800.0


def make_mesh(n_devices: Optional[int] = None,
              device="cuda") -> List[torch.device]:
    """The devices of an ``n_devices``-way split: the first ``n_devices``
    visible cards (all of them by default), or for ``device="cpu"``
    ``n_devices`` (default 1) times the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    if dev.type != "cuda":
        raise ValueError(f"make_mesh: no devices of type {dev.type}")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"{n} devices asked for, {count} CUDA cards "
                         f"visible")
    return [torch.device("cuda", i) for i in range(n)]


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device="cuda",
                     backend: Optional[str] = None) -> Optional[str]:
    """Join the default process group of ``num_processes`` ranks as rank
    ``process_id``, rendezvous at ``tcp://<coordinator>`` (host:port).
    Without a coordinator and at one process this does nothing and
    returns None; with a coordinator it joins whatever the count (a group
    of one runs the backend on one card).  Returns the backend."""
    world = int(num_processes or 1)
    if coordinator is None:
        if world > 1:
            raise ValueError(f"{world} processes need a coordinator "
                             f"address (host:port)")
        return None
    rank = int(process_id or 0)
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside 0..{world - 1}")
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    # NCCL builds its communicator at the first collective: run one now
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe)
    if probe.item() != world:
        raise RuntimeError(f"{backend}: the first all_reduce over {world} "
                           f"ranks gave {probe.item()}")
    return backend


def world_and_rank() -> tuple:
    """(world size, rank) of the default process group; (1, 0) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s sampler generator: ``seed + rank·2³²``
    (rank 0's is ``seed``, what one process draws from)."""
    return int(seed) + (int(rank) << 32)


def _flat_groups(tensors: Iterable[torch.Tensor]):
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return groups.values()


def _flat_collective(tensors, run) -> None:
    for group in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        run(flat)
        for t, piece in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(piece.view_as(t))


@torch.no_grad()
def all_reduce_mean_(tensors: Iterable[torch.Tensor]) -> None:
    """Every tensor replaced by its mean over the ranks (the sum, then a
    division by the world size), the same bits on every rank."""
    world = dist.get_world_size()

    def run(flat):
        dist.all_reduce(flat)
        flat.div_(world)
    _flat_collective(tensors, run)


@torch.no_grad()
def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Every tensor replaced by rank ``src``'s."""
    _flat_collective(tensors, lambda flat: dist.broadcast(flat, src))
