"""Weights across the two packages.

``state_dict_from_jax`` turns the JAX package's parameter tree (numpy
arrays) into the port's ``state_dict``, under the reference mmdet names.  It
inverts ``hvrnet_tpu/utils/checkpoint.py:convert_torch_checkpoint``: conv
kernels HWIO → OIHW, dense kernels (in, out) → (out, in), the input axis
of the dense layers over flattened RoI maps (``roi_fcs``: ``fc_new_1``, or
a plain head's ``fc_cls`` / ``fc_reg``) from the JAX package's HWC RoI
flattening back to mmdet's CHW, ``linear_out`` back to a 1×1 conv, and the
frozen-BN names.  Because the names are mmdet's, a reference ``.pth``
state_dict loads straight into the port as well.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np
import torch

_BN_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}
ROI_FEAT_HW = 7


def _conv_w(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (3, 2, 0, 1))          # HWIO → OIHW


def roi_fcs(head: Dict[str, Any], bbox_head_cfg=None) -> frozenset:
    """The bbox head's dense layers over flattened 7×7 RoI maps, from the
    head's structure (not from their input sizes): a relation head's
    ``fc_new_1`` (its ``fc_cls`` / ``fc_reg`` read fc features); a plain
    ``BBoxHead``'s ``fc_cls`` and ``fc_reg`` unless its config says
    ``with_avg_pool``.  ``head``: the JAX tree's ``bbox_head`` subtree."""
    if "fc_new_1" in head:
        return frozenset({"fc_new_1"})
    if bbox_head_cfg is None:
        raise ValueError("a plain bbox head's fc_cls / fc_reg read the "
                         "flattened RoI map unless it average-pools: pass "
                         "the model config to say which")
    if bbox_head_cfg.get("with_avg_pool", False):
        return frozenset()
    return frozenset({"fc_cls", "fc_reg"})


def _fc_w(w: np.ndarray, roi: bool) -> np.ndarray:
    """Dense (in, out) → Linear (out, in); a RoI fc's input axis goes from
    the JAX package's HWC flattening to mmdet's CHW."""
    if not roi:
        return np.transpose(w, (1, 0))
    in_dim, out_dim = w.shape
    c = in_dim // (ROI_FEAT_HW ** 2)
    w = w.T.reshape(out_dim, ROI_FEAT_HW, ROI_FEAT_HW, c)
    return np.transpose(w, (0, 3, 1, 2)).reshape(out_dim, in_dim)


def _conv_bn(prefix: str, node: Dict[str, Any], out: Dict[str, np.ndarray],
             conv_name: str, bn_name: str):
    """A JAX ConvBN subtree {conv: {kernel}, bn: {...}} → mmdet names."""
    out[f"{prefix}.{conv_name}.weight"] = _conv_w(node["conv"]["kernel"])
    for k, v in node["bn"].items():
        out[f"{prefix}.{bn_name}.{_BN_NAMES[k]}"] = v


def _res_layers(prefix: str, tree: Dict[str, Any], out: Dict[str, np.ndarray]):
    for layer, blocks in tree.items():
        if not layer.startswith("layer"):
            continue
        for block, sub in blocks.items():
            base = f"{prefix}.{layer}.{int(block[len('block'):])}"
            for name, node in sub.items():
                if name == "downsample":
                    _conv_bn(base, node, out, "downsample.0", "downsample.1")
                else:                                   # conv1 / conv2 / conv3
                    _conv_bn(base, node, out, name, "bn" + name[len("conv"):])


def state_dict_from_jax(params: Dict[str, Any],
                        model_cfg: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, torch.Tensor]:
    """JAX param tree (``{'params': …}`` or its inner dict) → port
    ``state_dict`` of float32 tensors.  ``model_cfg`` is needed for a plain
    ``BBoxHead`` (``roi_fcs``)."""
    tree = params.get("params", params)
    tree = _to_numpy(tree)
    out: Dict[str, np.ndarray] = {}
    bb = tree["backbone"]
    out["backbone.conv1.weight"] = _conv_w(bb["stem"]["conv"]["kernel"])
    for k, v in bb["stem"]["bn"].items():
        out[f"backbone.bn1.{_BN_NAMES[k]}"] = v
    _res_layers("backbone", bb, out)

    sh = tree.get("shared_head", {})
    _res_layers("shared_head", sh, out)
    if "new_layer_1" in sh:
        conv = sh["new_layer_1"]["conv"]
        out["shared_head.new_layer_1.conv.weight"] = _conv_w(conv["kernel"])
        out["shared_head.new_layer_1.conv.bias"] = conv["bias"]

    for name, node in tree["rpn_head"].items():
        out[f"rpn_head.{name}.weight"] = _conv_w(node["kernel"])
        out[f"rpn_head.{name}.bias"] = node["bias"]

    head = bbox_head_state_dict(tree["bbox_head"], None if model_cfg is None
                                else model_cfg["bbox_head"])
    out.update({f"bbox_head.{k}": v for k, v in head.items()})
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in out.items()}


def bbox_head_state_dict(head: Dict[str, Any], bbox_head_cfg=None
                         ) -> Dict[str, np.ndarray]:
    """The JAX tree's ``bbox_head`` subtree → the head module's own
    ``state_dict`` arrays (names without the ``bbox_head.`` prefix)."""
    head = _to_numpy(head)
    roi = roi_fcs(head, bbox_head_cfg)
    out: Dict[str, np.ndarray] = {}
    for name, node in head.items():
        m = re.fullmatch(r"selsa_(\d+)", name)
        if m is None:
            out[f"{name}.weight"] = _fc_w(node["kernel"], name in roi)
            out[f"{name}.bias"] = node["bias"]
            continue
        i = m.group(1)
        for inner, fc in node.items():
            key = f"{name}.{inner}_{i}"
            if inner == "linear_out":
                out[key + ".weight"] = fc["kernel"].T[:, :, None, None]
            else:
                out[key + ".weight"] = fc["kernel"].T
            out[key + ".bias"] = fc["bias"]
    return out


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)
