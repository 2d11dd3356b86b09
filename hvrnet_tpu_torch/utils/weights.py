"""Weights across the two packages.

``state_dict_from_jax`` turns the JAX package's parameter tree (numpy
arrays) into the port's ``state_dict``, under the reference mmdet names.  It
inverts ``hvrnet_tpu/utils/checkpoint.py:convert_torch_checkpoint``: conv
kernels HWIO → OIHW, dense kernels (in, out) → (out, in), the ``fc_new_1``
input axis from the JAX package's HWC RoI flattening back to mmdet's CHW,
``linear_out`` back to a 1×1 conv, and the frozen-BN names.  Because the
names are mmdet's, a reference ``.pth`` state_dict loads straight into the
port as well.
"""
from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

_BN_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}
ROI_FEAT_HW = 7


def _conv_w(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (3, 2, 0, 1))          # HWIO → OIHW


def _is_roi_fc(name: str, w: np.ndarray) -> bool:
    """Dense layers over flattened 7×7 RoI maps (the JAX converter's rule)."""
    in_dim = w.shape[0]
    return (name in ("fc_new_1", "shared_fc0", "fc_cls", "fc_reg", "fc0")
            and in_dim % (ROI_FEAT_HW ** 2) == 0 and in_dim >= 2048)


def _fc_w(name: str, w: np.ndarray) -> np.ndarray:
    """Dense (in, out) → Linear (out, in); RoI fcs go HWC → CHW on input."""
    if not _is_roi_fc(name, w):
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


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX param tree (``{'params': …}`` or its inner dict) → port
    ``state_dict`` of float32 tensors."""
    tree = params.get("params", params)
    tree = _to_numpy(tree)
    out: Dict[str, np.ndarray] = {}

    bb = tree["backbone"]
    out["backbone.conv1.weight"] = _conv_w(bb["stem"]["conv"]["kernel"])
    for k, v in bb["stem"]["bn"].items():
        out[f"backbone.bn1.{_BN_NAMES[k]}"] = v
    _res_layers("backbone", bb, out)

    sh = tree["shared_head"]
    _res_layers("shared_head", sh, out)
    if "new_layer_1" in sh:
        conv = sh["new_layer_1"]["conv"]
        out["shared_head.new_layer_1.conv.weight"] = _conv_w(conv["kernel"])
        out["shared_head.new_layer_1.conv.bias"] = conv["bias"]

    for name, node in tree["rpn_head"].items():
        out[f"rpn_head.{name}.weight"] = _conv_w(node["kernel"])
        out[f"rpn_head.{name}.bias"] = node["bias"]

    for name, node in tree["bbox_head"].items():
        m = re.fullmatch(r"selsa_(\d+)", name)
        if m is None:
            out[f"bbox_head.{name}.weight"] = _fc_w(name, node["kernel"])
            out[f"bbox_head.{name}.bias"] = node["bias"]
            continue
        i = m.group(1)
        for inner, fc in node.items():
            key = f"bbox_head.{name}.{inner}_{i}"
            if inner == "linear_out":
                out[key + ".weight"] = fc["kernel"].T[:, :, None, None]
            else:
                out[key + ".weight"] = fc["kernel"].T
            out[key + ".bias"] = fc["bias"]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in out.items()}


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)
