"""Lockstep lanes split over devices (the port's form of the JAX engine's
``enable_spmd_lanes``, ``hvrnet_tpu/engine/detector.py:247-285``).

The JAX package runs the B lanes of the lockstep runner as one program
sharded over a mesh, with no coupling between lanes.  The port keeps one
replica of the engine per device in one process: replica i runs lanes
``i·B/n … (i+1)·B/n − 1`` of the frame program, the ring push and the
ring detect, and its pieces travel between those calls as ``LaneShards``,
in lane order.  ``on_replicas`` starts every replica's call on its own
host thread before it waits on any: CUDA launches are asynchronous, and a
replica's host reads (the NMS fixpoint's checks) then stall only its own
thread.  Each thread makes its replica's card the current device (a
thread starts on card 0, and a launch into another card's stream fails).
A device may repeat (two replicas on one card).
"""
from __future__ import annotations

import concurrent.futures as cf
from typing import Callable, List, Sequence

import torch


def lane_slices(batch: int, n: int) -> List[slice]:
    """The n replicas' lanes of a batch of ``batch`` lanes, which ``n``
    divides (the JAX engine's rule and message)."""
    if batch % n:
        raise ValueError(f"SPMD lanes need batch % mesh.size == 0 (got "
                         f"B={batch}, {n} devices)")
    per = batch // n
    return [slice(i * per, (i + 1) * per) for i in range(n)]


class LaneShards(list):
    """The replicas' pieces of a lane-axis value, in lane order (dicts of
    (B/n, …) tensors, one per replica, each on its replica's device).
    ``shards[key]`` gathers one key's lanes onto the first piece's
    device."""

    def __getitem__(self, key):
        if isinstance(key, str):
            first = super().__getitem__(0)[key]
            return torch.cat([s[key].to(first.device) for s in self])
        return super().__getitem__(key)


def _on_device(call: Callable[[], object], device: torch.device):
    if device.type != "cuda":
        return call()
    with torch.cuda.device(device):
        return call()


def on_replicas(calls: Sequence[Callable[[], object]],
                devices: Sequence[torch.device]) -> list:
    """Every zero-argument call on its own thread with its device (a card
    made current there), all started before any is waited on; their
    results in order (a call's exception is raised here)."""
    if len(calls) == 1:
        return [_on_device(calls[0], devices[0])]
    with cf.ThreadPoolExecutor(max_workers=len(calls)) as pool:
        futures = [pool.submit(_on_device, call, dev)
                   for call, dev in zip(calls, devices)]
        return [f.result() for f in futures]


def gather_lanes(outs: list, device: torch.device):
    """The replicas' outputs (tensors, or tuples and lists of them, each
    with the lane axis first) joined in lane order on ``device``."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(device, non_blocking=True) for o in outs])
    joined = [gather_lanes([o[i] for o in outs], device)
              for i in range(len(first))]
    return tuple(joined) if isinstance(first, tuple) else joined
