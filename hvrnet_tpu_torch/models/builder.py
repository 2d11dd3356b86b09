"""Config-driven builders (counterpart of ``hvrnet_tpu/models/builder.py``)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..utils.config import unwrap
from .roi_extractor import SingleRoIExtractor
from .two_stage import TwoStageModule


def build_roi_extractor(cfg: Dict[str, Any]) -> SingleRoIExtractor:
    cfg = dict(unwrap(cfg))
    cfg.pop("type", None)
    return SingleRoIExtractor(**cfg)


def build_model_module(model_cfg: Dict[str, Any],
                       dtype: torch.dtype = torch.float32) -> TwoStageModule:
    """The detector's modules, computing in ``dtype`` with float32
    parameters."""
    m = unwrap(model_cfg)
    return TwoStageModule(backbone=m["backbone"],
                          shared_head=m.get("shared_head"),
                          rpn_head=m["rpn_head"], bbox_head=m["bbox_head"],
                          dtype=dtype)
