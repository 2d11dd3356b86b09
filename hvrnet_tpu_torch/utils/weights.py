"""Weights across the two packages.

``state_dict_from_jax`` turns the JAX package's parameter tree (numpy
arrays) into the port's ``state_dict``, under the reference mmdet names.  It
inverts ``hvrnet_tpu/utils/checkpoint.py:convert_torch_checkpoint`` and
extends it to the multi-stage zoo: conv kernels HWIO → OIHW, dense kernels
(in, out) → (out, in), the input axis of the dense layers over flattened
RoI maps (``roi_fcs``) from the JAX package's HWC RoI flattening back to
mmdet's CHW, ``linear_out`` back to a 1×1 conv, the frozen-BN names, the
per-stage heads ``bbox_head{i}`` → ``bbox_head.{i}`` (one head:
``bbox_head``), the ConvFC heads' ``shared_fc{k}`` / ``cls_conv{k}`` / … →
``shared_fcs.{k}`` / ``cls_convs.{k}`` / …, and the mask head's
``conv{k}`` → ``convs.{k}.conv`` and its ``upsample``, whose kernel flax
applies unflipped (``nn.ConvTranspose`` without ``transpose_kernel``) and
torch's ``ConvTranspose2d`` flipped: it is transposed to (in, out, kh, kw)
and flipped in both spatial axes.  Because the names are mmdet's, a
reference ``.pth`` state_dict loads straight into the port as well.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np
import torch

_BN_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}
# the JAX ConvFC heads' names → mmdet's
_CONVFC_NAMES = re.compile(r"(shared|cls|reg)_(conv|fc)(\d+)")


def _conv_w(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (3, 2, 0, 1))          # HWIO → OIHW


def _deconv_w(w: np.ndarray) -> np.ndarray:
    """flax ConvTranspose (kh, kw, in, out), unflipped → torch
    ConvTranspose2d (in, out, kh, kw), which flips its kernel."""
    return np.transpose(w, (2, 3, 0, 1))[:, :, ::-1, ::-1]


def roi_fcs(head: Dict[str, Any], bbox_head_cfg=None) -> frozenset:
    """The port names of the bbox head's dense layers over flattened RoI
    maps, from the head's structure (not from their input sizes): a
    relation head's ``fc_new_1`` (its ``fc_cls`` / ``fc_reg`` read fc
    features); otherwise the port head's ``flat_map_fcs`` (a plain
    ``BBoxHead``'s ``fc_cls`` and ``fc_reg`` unless ``with_avg_pool``; a
    ConvFC head's first dense layer of each branch that holds the map),
    built from its config on the meta device.  ``head``: the JAX tree's
    bbox head subtree."""
    if "fc_new_1" in head:
        return frozenset({"fc_new_1"})
    if bbox_head_cfg is None:
        raise ValueError("a plain bbox head's fc_cls / fc_reg read the "
                         "flattened RoI map unless it average-pools: pass "
                         "the model config to say which")
    from ..models.registry import HEADS
    from ..models.two_stage import build_submodule
    with torch.device("meta"):
        return build_submodule(bbox_head_cfg, HEADS).flat_map_fcs


def _fc_w(w: np.ndarray, roi: bool, hw: int = 7) -> np.ndarray:
    """Dense (in, out) → Linear (out, in); a RoI fc's input axis goes from
    the JAX package's HWC flattening of (hw, hw, C) to mmdet's CHW."""
    if not roi:
        return np.transpose(w, (1, 0))
    in_dim, out_dim = w.shape
    c = in_dim // (hw ** 2)
    w = w.T.reshape(out_dim, hw, hw, c)
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
    ``state_dict`` of float32 tensors.  ``model_cfg`` is needed for any
    head but a relation head (``roi_fcs``)."""
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

    cfg = None if model_cfg is None else model_cfg["bbox_head"]
    if "bbox_head" in tree:
        heads = {"bbox_head": (tree["bbox_head"], cfg)}
    elif isinstance(cfg, (list, tuple)):    # the multi-stage module's
        heads = {f"bbox_head.{i}": (tree[f"bbox_head{i}"], c)
                 for i, c in enumerate(cfg)}
    else:
        heads = {"bbox_head": (tree["bbox_head0"], cfg)}
    for prefix, (node, head_cfg) in heads.items():
        out.update({f"{prefix}.{k}": v for k, v in
                    bbox_head_state_dict(node, head_cfg).items()})
    if "mask_head" in tree:
        out.update({f"mask_head.{k}": v for k, v in
                    mask_head_state_dict(tree["mask_head"]).items()})
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in out.items()}


def bbox_head_state_dict(head: Dict[str, Any], bbox_head_cfg=None
                         ) -> Dict[str, np.ndarray]:
    """A JAX bbox head subtree → the head module's own ``state_dict``
    arrays (names without the ``bbox_head.`` prefix)."""
    head = _to_numpy(head)
    roi = roi_fcs(head, bbox_head_cfg)
    hw = int((bbox_head_cfg or {}).get("roi_feat_size", 7))
    out: Dict[str, np.ndarray] = {}
    for name, node in head.items():
        port = _CONVFC_NAMES.sub(lambda m: f"{m[1]}_{m[2]}s.{m[3]}", name)
        if "bn" in node:                            # a ConvBN
            _conv_bn(port, node, out, "conv", "bn")
            continue
        m = re.fullmatch(r"selsa_(\d+)", name)
        if m is None:
            out[f"{port}.weight"] = _fc_w(node["kernel"], port in roi, hw)
            out[f"{port}.bias"] = node["bias"]
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


def mask_head_state_dict(head: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX ``FCNMaskHead`` subtree → the port head's ``state_dict``
    arrays: ``conv{k}`` → ``convs.{k}.conv``, ``upsample`` transposed and
    flipped (``_deconv_w``), ``conv_logits``."""
    out: Dict[str, np.ndarray] = {}
    for name, node in _to_numpy(head).items():
        if name == "upsample":
            out["upsample.weight"] = _deconv_w(node["kernel"])
            out["upsample.bias"] = node["bias"]
            continue
        port = re.sub(r"^conv(\d+)$", r"convs.\1.conv", name)
        out[f"{port}.weight"] = _conv_w(node["kernel"])
        out[f"{port}.bias"] = node["bias"]
    return out


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)
