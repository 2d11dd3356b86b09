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
and flipped in both spatial axes.  The FPN zoo adds the 4-stage backbone
(``layer4``, ``BasicBlock``'s ``conv1`` / ``conv2``), the neck
(``neck_state_dict``), HTC's per-stage mask heads ``mask_head{i}`` →
``mask_head.{i}`` with ``conv_res``, the semantic head
(``semantic_head_state_dict``), and the MaskIoU and grid heads
(``mask_iou_head_state_dict``: ``fc0`` reads the flattened map;
``grid_head_state_dict``: two more flipped transposed convs).  A
single-stage tree (no ``rpn_head``) has a dense ``bbox_head``
(``dense_head_state_dict``) and a ResNet or ``SSDVGG`` backbone
(``ssd_vgg_state_dict``); a ``dcn`` block's ``conv2_offset``,
``conv2_kernel`` and ``conv2_bn`` → ``conv2_offset``, ``conv2`` and
``bn2``.  Because the names are mmdet's, a reference
``.pth`` state_dict loads straight into the port as well.
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
            base = f"{prefix}{layer}.{int(block[len('block'):])}"
            for name, node in sub.items():
                if name == "downsample":
                    _conv_bn(base, node, out, "downsample.0", "downsample.1")
                elif name == "conv2_offset":            # the dcn plugin's
                    out.update(_convs(sub, {name: f"{base}.conv2_offset"}))
                elif name == "conv2_kernel":
                    out[f"{base}.conv2.weight"] = _conv_w(node)
                elif name == "conv2_bn":
                    for k, v in node.items():
                        out[f"{base}.bn2.{_BN_NAMES[k]}"] = v
                else:                                   # conv1 / conv2 / conv3
                    _conv_bn(base, node, out, name, "bn" + name[len("conv"):])


def backbone_state_dict(backbone: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX ``ResNet`` subtree → mmdet's names (without the
    ``backbone.`` prefix): the stem's conv and BN → ``conv1`` / ``bn1``,
    each block's ConvBNs → ``convK`` / ``bnK``, ``downsample.{0,1}``."""
    bb = _to_numpy(backbone)
    out = {"conv1.weight": _conv_w(bb["stem"]["conv"]["kernel"])}
    for k, v in bb["stem"]["bn"].items():
        out[f"bn1.{_BN_NAMES[k]}"] = v
    _res_layers("", bb, out)
    return out


def state_dict_from_jax(params: Dict[str, Any],
                        model_cfg: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, torch.Tensor]:
    """JAX param tree (``{'params': …}`` or its inner dict) → port
    ``state_dict`` of float32 tensors.  ``model_cfg`` is needed for any
    head but a relation head (``roi_fcs``)."""
    tree = params.get("params", params)
    tree = _to_numpy(tree)
    bb = tree["backbone"]
    out: Dict[str, np.ndarray] = {
        f"backbone.{k}": v for k, v in (
            backbone_state_dict(bb) if "stem" in bb
            else ssd_vgg_state_dict(bb)).items()}
    if "rpn_head" not in tree:          # a single-stage detector
        out.update({f"bbox_head.{k}": v for k, v in
                    dense_head_state_dict(tree["bbox_head"]).items()})
        if "neck" in tree:
            out.update({f"neck.{k}": v for k, v in
                        neck_state_dict(tree["neck"]).items()})
        return _tensors(out)

    sh = tree.get("shared_head", {})
    _res_layers("shared_head.", sh, out)
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
    if "neck" in tree:
        out.update({f"neck.{k}": v for k, v in
                    neck_state_dict(tree["neck"]).items()})
    for name, node in tree.items():     # mask_head, or HTC's mask_head{i}
        m = re.fullmatch(r"mask_head(\d*)", name)
        if m:
            prefix = f"mask_head.{m[1]}" if m[1] else "mask_head"
            out.update({f"{prefix}.{k}": v for k, v in
                        mask_head_state_dict(node).items()})
    if "semantic_head" in tree:
        fusion = int(((model_cfg or {}).get("semantic_head") or {}).get(
            "fusion_level", 1))
        out.update({f"semantic_head.{k}": v for k, v in
                    semantic_head_state_dict(tree["semantic_head"],
                                             fusion).items()})
    if "mask_iou_head" in tree:
        out.update({f"mask_iou_head.{k}": v for k, v in
                    mask_iou_head_state_dict(
                        tree["mask_iou_head"],
                        (model_cfg or {}).get("mask_iou_head")).items()})
    if "grid_head" in tree:
        out.update({f"grid_head.{k}": v for k, v in
                    grid_head_state_dict(tree["grid_head"]).items()})
    return _tensors(out)


def _tensors(out: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in out.items()}


def ssd_vgg_state_dict(backbone: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX ``SSDVGG`` subtree → the port module's mmdet names
    (``models/backbones/resnext.py:port_name``: ``conv{i}`` →
    ``features.{k}``, ``fc6`` / ``fc7`` → ``features.31`` / ``.33``,
    ``extra{i}`` → ``extra.{i}``, ``l2_norm_scale`` →
    ``l2_norm.weight``)."""
    from ..models.backbones.resnext import port_name
    out: Dict[str, np.ndarray] = {}
    for name, node in _to_numpy(backbone).items():
        if name == "l2_norm_scale":
            out[port_name(name)] = node
        else:
            out.update(_convs(backbone, {name: port_name(name)}))
    return out


# RepPoints' JAX layer names → mmdet's
_REPPOINTS = {"pts_init_conv": "reppoints_pts_init_conv",
              "pts_init_out": "reppoints_pts_init_out",
              "cls_dcn_kernel": "reppoints_cls_conv",
              "cls_out": "reppoints_cls_out",
              "pts_refine_kernel": "reppoints_pts_refine_conv",
              "pts_refine_out": "reppoints_pts_refine_out"}


def dense_head_state_dict(head: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX dense head subtree → mmdet's names: the towers'
    ``cls_conv{i}`` / ``reg_conv{i}`` → ``cls_convs.{i}.conv`` / …, FCOS's
    ``cls_gn{i}`` / ``reg_gn{i}`` → ``cls_convs.{i}.gn`` / …,
    ``scale{i}`` → ``scales.{i}.scale``; the output convs (``retina_cls``,
    ``retina_reg``, ``fcos_cls``, ``fcos_reg``, ``fcos_centerness``,
    ``fovea_cls``, ``fovea_reg``, ``conv_loc``, ``conv_shape``,
    ``conv_cls``, ``conv_reg``) keep their names.  An ``SSDHead``'s
    per-level ``cls_conv{i}`` / ``reg_conv{i}`` (its only convs) →
    ``cls_convs.{i}`` / ``reg_convs.{i}``.  The deformable heads:
    ``feature_adaption[_cls|_reg]_offset`` (a bias-free conv) and
    ``_kernel`` (a bare HWIO kernel) → ``feature_adaption[_cls|_reg].
    conv_offset`` / ``.conv_adaption``; RepPoints' ``pts_conv{i}`` →
    ``pts_convs.{i}.conv``, its other layers → ``reppoints_*``
    (``_REPPOINTS``), ``moment_transfer`` as it is."""
    head = _to_numpy(head)
    towers = re.compile(r"(cls|reg|pts)_(conv|gn)(\d+)")
    adaption = re.compile(r"(feature_adaption(?:_cls|_reg)?)_(offset|kernel)")
    ssd = all(towers.fullmatch(n) for n in head)
    out: Dict[str, np.ndarray] = {}
    for name, node in head.items():
        m = towers.fullmatch(name)
        scale = re.fullmatch(r"scale(\d+)", name)
        fa = adaption.fullmatch(name)
        if name == "moment_transfer":
            out[name] = node
        elif fa and fa[2] == "offset":
            out[f"{fa[1]}.conv_offset.weight"] = _conv_w(node["kernel"])
        elif fa:
            out[f"{fa[1]}.conv_adaption.weight"] = _conv_w(node)
        elif name.endswith("_kernel"):
            out[f"{_REPPOINTS[name]}.weight"] = _conv_w(node)
        elif scale:
            out[f"scales.{scale[1]}.scale"] = node["scale"]
        elif m and m[2] == "gn":
            out[f"{m[1]}_convs.{m[3]}.gn.weight"] = node["scale"]
            out[f"{m[1]}_convs.{m[3]}.gn.bias"] = node["bias"]
        else:
            port = (_REPPOINTS.get(name, name) if m is None
                    else f"{m[1]}_convs.{m[3]}" + ("" if ssd else ".conv"))
            out.update(_convs(head, {name: port}))
    return out


def _convs(node: Dict[str, Any], names: Dict[str, str]
           ) -> Dict[str, np.ndarray]:
    """Conv subtrees {kernel, bias} → ``{port}.weight`` / ``.bias`` under
    ``names[jax name]``."""
    out: Dict[str, np.ndarray] = {}
    for name, port in names.items():
        out[f"{port}.weight"] = _conv_w(node[name]["kernel"])
        out[f"{port}.bias"] = node[name]["bias"]
    return out


def neck_state_dict(neck: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX ``FPN`` subtree → mmdet's names: ``lateral_conv{i}`` →
    ``lateral_convs.{i}.conv``, ``fpn_conv{i}`` → ``fpn_convs.{i}.conv``,
    ``extra_conv{i}`` → ``fpn_convs.{levels + i}.conv``."""
    neck = _to_numpy(neck)
    levels = sum(k.startswith("lateral_conv") for k in neck)
    names = {}
    for name in neck:
        kind, i = re.fullmatch(r"(lateral|fpn|extra)_conv(\d+)",
                               name).groups()
        i = int(i) + (levels if kind == "extra" else 0)
        names[name] = (f"lateral_convs.{i}.conv" if kind == "lateral"
                       else f"fpn_convs.{i}.conv")
    return _convs(neck, names)


def semantic_head_state_dict(head: Dict[str, Any], fusion_level: int = 1
                             ) -> Dict[str, np.ndarray]:
    """The JAX ``FusedSemanticHead`` subtree → mmdet's names:
    ``lateral_fuse`` → ``lateral_convs.{fusion_level}.conv``,
    ``lateral{i}`` → ``lateral_convs.{i}.conv``, ``conv{i}`` →
    ``convs.{i}.conv``, ``conv_seg`` → ``conv_logits``, ``conv_embedding``
    → ``conv_embedding.conv``."""
    head = _to_numpy(head)
    names = {}
    for name in head:
        m = re.fullmatch(r"(lateral|conv)(\d+)", name)
        if name == "lateral_fuse":
            names[name] = f"lateral_convs.{fusion_level}.conv"
        elif m:
            names[name] = (f"lateral_convs.{m[2]}.conv" if m[1] == "lateral"
                           else f"convs.{m[2]}.conv")
        else:
            names[name] = {"conv_seg": "conv_logits",
                           "conv_embedding": "conv_embedding.conv"}[name]
    return _convs(head, names)


def mask_iou_head_state_dict(head: Dict[str, Any], head_cfg=None
                             ) -> Dict[str, np.ndarray]:
    """The JAX ``MaskIoUHead`` subtree → mmdet's names: ``conv{i}`` →
    ``convs.{i}.conv``, ``fc{i}`` → ``fcs.{i}``, ``fc_mask_iou``; the dense
    layer on the flattened map (the port head's ``flat_map_fcs``, built
    from ``head_cfg`` on the meta device) has its input axis permuted from
    the JAX HWC flattening to CHW."""
    from ..models.registry import HEADS
    from ..models.two_stage import build_submodule
    head = _to_numpy(head)
    cfg = dict(head_cfg or {}, type="MaskIoUHead")
    with torch.device("meta"):
        port_head = build_submodule(cfg, HEADS)
    out: Dict[str, np.ndarray] = {}
    for name, node in head.items():
        m = re.fullmatch(r"(conv|fc)(\d+)", name)
        if m and m[1] == "conv":
            out.update(_convs(head, {name: f"convs.{m[2]}.conv"}))
            continue
        port = f"fcs.{m[2]}" if m else name
        out[f"{port}.weight"] = _fc_w(node["kernel"],
                                      port in port_head.flat_map_fcs,
                                      port_head.flat_map_hw)
        out[f"{port}.bias"] = node["bias"]
    return out


def grid_head_state_dict(head: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX ``GridHead`` subtree → the port head's names: ``conv{i}``
    → ``convs.{i}.conv``, ``gn{i}`` (scale, bias) → ``convs.{i}.gn``,
    ``deconv1`` / ``deconv2`` transposed and flipped (``_deconv_w``)."""
    out: Dict[str, np.ndarray] = {}
    for name, node in _to_numpy(head).items():
        m = re.fullmatch(r"(conv|gn)(\d+)", name)
        if m is None:
            out[f"{name}.weight"] = _deconv_w(node["kernel"])
            out[f"{name}.bias"] = node["bias"]
        elif m[1] == "conv":
            out.update(_convs(head, {name: f"convs.{m[2]}.conv"}))
        else:
            out[f"convs.{m[2]}.gn.weight"] = node["scale"]
            out[f"convs.{m[2]}.gn.bias"] = node["bias"]
    return out


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
    """The JAX ``FCNMaskHead`` or ``HTCMaskHead`` subtree → the port
    head's ``state_dict`` arrays: ``conv{k}`` → ``convs.{k}.conv``,
    ``conv_res`` → ``conv_res.conv``, ``upsample`` transposed and flipped
    (``_deconv_w``), ``conv_logits``."""
    out: Dict[str, np.ndarray] = {}
    for name, node in _to_numpy(head).items():
        if name == "upsample":
            out["upsample.weight"] = _deconv_w(node["kernel"])
            out["upsample.bias"] = node["bias"]
            continue
        port = ("conv_res.conv" if name == "conv_res" else
                re.sub(r"^conv(\d+)$", r"convs.\1.conv", name))
        out[f"{port}.weight"] = _conv_w(node["kernel"])
        out[f"{port}.bias"] = node["bias"]
    return out


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)
