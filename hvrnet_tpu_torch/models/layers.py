"""Common building blocks (NCHW), counterparts of ``hvrnet_tpu/models/layers.py``.

Every BatchNorm in the shipped configs is frozen (``requires_grad=False`` +
``norm_eval=True``), so ``FrozenBN`` is a constant per-channel affine built
from the four stored tensors.  It keeps mmdet's BatchNorm names (``weight``,
``bias``, ``running_mean``, ``running_var``) so a reference ``state_dict``
loads by name.

Every module computes in the ``dtype`` it was built with and keeps float32
parameters (``core/precision.py``): ``Conv2d`` and ``Linear`` are torch's
layers with flax's ``dtype=`` / ``param_dtype=float32`` split.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import to_compute


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that casts its input, weight and bias to
    ``compute_dtype`` at the call."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else to_compute(self.bias, dt)
        return self._conv_forward(to_compute(x, dt),
                                  to_compute(self.weight, dt), bias)


class Linear(nn.Linear):
    """``nn.Linear`` that casts its input, weight and bias to
    ``compute_dtype`` at the call."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else to_compute(self.bias, dt)
        return F.linear(to_compute(x, dt), to_compute(self.weight, dt), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that casts its input, weight and bias to
    ``compute_dtype`` at the call."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else to_compute(self.bias, dt)
        return F.conv_transpose2d(to_compute(x, dt),
                                  to_compute(self.weight, dt), bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class FrozenBN(nn.Module):
    """BatchNorm with frozen statistics and affine params (inference form):
    ``scale = γ·rsqrt(var + eps)``, ``bias = β − mean·scale``, computed in
    float32 and applied in ``dtype``."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a reference BatchNorm2d state_dict also carries its update counter,
        # which a frozen BN has no use for
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        bias = self.bias - self.running_mean * scale
        scale = to_compute(scale, self.dtype)[None, :, None, None]
        bias = to_compute(bias, self.dtype)[None, :, None, None]
        return x * scale + bias


class ConvModule(nn.Module):
    """mmdet ConvModule without a norm: conv(+bias) → ReLU, or the conv
    alone with ``activation=None`` (the shared head's ``external_conv``,
    the mask heads' convs, the FPN's laterals; its parameters live under
    ``.conv``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, dtype: torch.dtype = torch.float32,
                 padding: int = 0, stride: int = 1,
                 activation: Optional[str] = "relu"):
        super().__init__()
        if activation not in ("relu", None):
            raise ValueError(f"activation {activation!r}: the port has "
                             "'relu' and None")
        self.conv = Conv2d(in_channels, out_channels, kernel_size,
                           stride=stride, padding=padding,
                           compute_dtype=dtype)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return F.relu(x) if self.activation else x


class ConvBN(nn.Module):
    """conv (no bias) → frozen BN → ReLU (counterpart of
    ``hvrnet_tpu/models/layers.py:ConvBN``; mmdet's ConvModule with a norm,
    whose parameters live under ``.conv`` and ``.bn``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, padding: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size,
                           padding=padding, bias=False, compute_dtype=dtype)
        self.bn = FrozenBN(out_channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def max_pool_3x3_s2_p1(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def conv1x1_as_linear(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1×1 Conv2d applied to (N, C) rows — the reference's ``linear_out``
    runs on (N, C, 1, 1) maps, which is a dense layer), in the conv's
    compute dtype."""
    dt = conv.compute_dtype
    w = conv.weight.reshape(conv.weight.shape[0], conv.weight.shape[1])
    return F.linear(to_compute(x, dt), to_compute(w, dt),
                    to_compute(conv.bias, dt))
