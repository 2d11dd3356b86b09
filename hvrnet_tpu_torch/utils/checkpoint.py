"""Training checkpoints in the port's own format: one ``torch.save`` file
holding the model ``state_dict`` (mmdet names), the optimizer state, the
step, the sampler's generator state (every rank's, in a data-parallel
run) and a meta dict (counterpart of
``hvrnet_tpu/utils/checkpoint.py``'s save/load, which writes orbax
directories)."""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    step: int = 0, meta: Optional[Dict[str, Any]] = None,
                    generator=None) -> None:
    """Write atomically: a reader never sees half a file.  ``generator``:
    the sampler's ``torch.Generator``, whose state is kept as ``rng``, or
    the states of every rank's generator (a list, rank by rank)."""
    rng = (generator.get_state() if isinstance(generator, torch.Generator)
           else generator)
    state = dict(state_dict=model.state_dict(), step=int(step),
                 meta=dict(meta or {}),
                 optimizer=optimizer.state_dict() if optimizer else None,
                 rng=rng)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def resolve_checkpoint(path: str) -> str:
    """``path``, or ``path + '.pth'`` where only that exists: a config's
    ``load_from = '.../latest'`` (the JAX package's checkpoint directory
    name) names the port's ``latest.pth``."""
    if not os.path.exists(path) and os.path.exists(path + ".pth"):
        return path + ".pth"
    return path


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """The saved dict; a bare ``state_dict`` (a reference ``.pth``'s
    weights alone) comes back under ``state_dict`` with step 0."""
    state = torch.load(path, map_location=map_location, weights_only=True)
    if "state_dict" not in state:
        state = dict(state_dict=state)
    state.setdefault("step", 0)
    state.setdefault("meta", {})
    return state
