"""Config-driven builders (counterpart of ``hvrnet_tpu/models/builder.py``)."""
from __future__ import annotations

from typing import Any, Dict

from ..utils.config import unwrap
from .roi_extractor import SingleRoIExtractor
from .two_stage import TwoStageModule


def build_roi_extractor(cfg: Dict[str, Any]) -> SingleRoIExtractor:
    cfg = dict(unwrap(cfg))
    cfg.pop("type", None)
    return SingleRoIExtractor(**cfg)


def build_model_module(model_cfg: Dict[str, Any]) -> TwoStageModule:
    m = unwrap(model_cfg)
    return TwoStageModule(backbone=m["backbone"],
                          shared_head=m["shared_head"],
                          rpn_head=m["rpn_head"], bbox_head=m["bbox_head"])
