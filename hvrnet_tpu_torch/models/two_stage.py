"""Two-stage detector module: backbone + shared head + RPN + bbox head
(counterpart of ``hvrnet_tpu/models/two_stage.py``).

The C5 configuration both shipped configs use: ``feat_from_shared_head``
moves the dilated stage 4 and its 1×1→256 conv before RoI pooling.  A
config without a ``shared_head`` pools C4 itself (``shared`` is then the
identity), as the JAX module allows.  The submodule names (``backbone``,
``shared_head``, ``rpn_head``, ``bbox_head``) are mmdet's, so the
module's ``state_dict`` is a reference checkpoint's; a ``bbox_head`` list
builds one head per stage, ``bbox_head.{i}`` as in mmdet's cascade.
Every submodule computes in the module's ``dtype`` (float32 parameters).
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, Optional

import torch
from torch import nn

from .registry import BACKBONES, HEADS, SHARED_HEADS


def build_submodule(cfg: Dict[str, Any], registry,
                    dtype: torch.dtype = torch.float32):
    """Instantiate ``cfg['type']`` from ``registry`` with the config keys its
    constructor takes and the compute ``dtype``; the other keys (losses,
    norm settings the frozen modules need not see) are dropped, as the JAX
    builder drops them."""
    cls = registry.get(cfg["type"])
    if cls is None:
        raise KeyError(f"{cfg['type']} not registered in {registry.name}")
    params = inspect.signature(cls.__init__).parameters
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in cfg.items() if k not in ("type", "dtype")
              and k in params}
    return cls(**kwargs, dtype=dtype)


class TwoStageModule(nn.Module):

    def __init__(self, backbone: dict, shared_head: Optional[dict],
                 rpn_head: dict, bbox_head: dict,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = build_submodule(backbone, BACKBONES, dtype)
        self.shared_head = (build_submodule(shared_head, SHARED_HEADS, dtype)
                            if shared_head else None)
        self.rpn_head = build_submodule(rpn_head, HEADS, dtype)
        # a list of per-stage heads is mmdet's cascade: bbox_head.{i}.*
        self.bbox_head = (
            nn.ModuleList(build_submodule(h, HEADS, dtype) for h in bbox_head)
            if isinstance(bbox_head, (list, tuple))
            else build_submodule(bbox_head, HEADS, dtype))

    def extract_feat(self, img):
        """(B, 3, H, W) → C4 (B, 1024, H/16, W/16)."""
        return self.backbone(img)[0]

    def shared(self, c4):
        """C4 → C5 (dilated stage 4 + external 1×1→256); C4 itself without
        a shared head."""
        return c4 if self.shared_head is None else self.shared_head(c4)

    def rpn(self, c4):
        """C4 → (cls logits, reg deltas) maps."""
        return self.rpn_head(c4)

    def bbox_forward(self, pooled, *args):
        """The bbox head on (N, C, 7, 7) pooled RoIs; a relation head also
        takes its row range and key mask in ``args``."""
        return self.bbox_head(pooled, *args)

    def bbox_stage(self, pooled, stage: int):
        """Stage ``stage``'s bbox head on (N, C, 7, 7) pooled RoIs (the one
        head where there is no list)."""
        heads = self.bbox_head
        return (heads[stage] if isinstance(heads, nn.ModuleList)
                else heads)(pooled)
