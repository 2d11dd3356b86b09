"""Masked attention: ``softmax(q·kᵀ·scale + bias)·v`` → (nq, d) float32.

Counterpart of ``hvrnet_tpu/ops/attention.py:masked_attention``.  On a CUDA
tensor it launches the hand-written Hopper kernel
(``csrc/masked_attention.cu``, which replaces the Pallas ``_flash_kernel``);
on a CPU tensor it runs ``attention_plain``, the straightforward expression
that the tests and ``chip_smoke.py`` hold the kernel against.

``bias`` is 0 for live keys and −1e30 for masked ones.  Inputs are float32
or bfloat16; logits, softmax and accumulation are float32; with bfloat16
inputs the softmax weights are rounded to bfloat16 before the product with
v.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import kernel_build

NEG_INF = -1e30

_BQ, _BK = 16, 64          # the kernel's query-tile rows and key-tile size
_KERNEL_DTYPES = {torch.float32: "hvr_masked_attention_f32",
                  torch.bfloat16: "hvr_masked_attention_bf16"}


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, scale: float) -> torch.Tensor:
    """The plain version: (nq, nk) logits, softmax, product with v."""
    aff = (q.float() @ k.float().T) * scale + bias.float()[None, :]
    w = torch.softmax(aff, dim=-1)
    return w.to(v.dtype).float() @ v.float()


def bf16_agreement(got: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, bias: torch.Tensor, scale: float) -> dict:
    """How far ``got``, the kernel's output on bfloat16 inputs, lies from
    ``attention_plain``'s, in units of what rounding the softmax weights to
    bfloat16 explains.  Both versions round each weight w_j with relative
    error ≤ u = 2^-8 (the kernel p_j against its running max, the plain
    version w_j after normalising), so the difference Δ obeys:

    * ``worst`` = max |Δ| / (2u·Σ_j w_j·|v_j|) ≤ 1, elementwise;
    * ``rms`` = rms(Δ) / (u·R), R² = mean of Σ_j w_j²·v_j²: independent
      roundings give ≈ 0.6, so ≤ 1 holds with margin;
    * ``rounds`` = rms(got − w·v) / (u·R): the kernel's own rounding leaves
      ≈ 0.4 between it and the unrounded product, and a kernel that skips
      the rounding ≈ 1e-4.  (With every key masked the weights are exactly 1
      in the kernel and nothing rounds.)
    """
    vf = v.float()
    w = torch.softmax((q.float() @ k.float().T) * scale
                      + bias.float()[None, :], dim=-1)
    delta = got - attention_plain(q, k, v, bias, scale)
    u = 2.0 ** -8
    bound = 2 * u * (w @ vf.abs()) + 1e-6        # + f32 rounding

    def rms(x):
        return x.square().mean().sqrt()

    r = rms((w.square() @ vf.square()).sqrt())
    return dict(max_abs_err=delta.abs().max().item(),
                worst=(delta.abs() / bound).max().item(),
                rms=(rms(delta) / (u * r)).item(),
                rounds=(rms(got - w @ vf) / (u * r)).item())


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, scale: float) -> torch.Tensor:
    """q: (nq, d); k, v: (nk, d); bias: (nk,) float32 → (nq, d) float32.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``masked_attention.launches``) or raise."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"masked_attention: unsupported device {q.device}")
    return _launch(q, k, v, bias, scale)


masked_attention.launches = 0


def _check(q, k, v, bias):
    nq, d = q.shape
    nk = k.shape[0]
    for name, t in (("k", k), ("v", v), ("bias", bias)):
        if t.device != q.device:
            raise ValueError(f"masked_attention: {name} on {t.device}, "
                             f"q on {q.device}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError("masked_attention kernel takes q, k, v all float32 "
                        f"or all bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"masked_attention bias must be float32, "
                        f"got {bias.dtype}")
    if k.shape != (nk, d) or v.shape != (nk, d) or bias.shape != (nk,):
        raise ValueError(f"masked_attention shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, bias "
                         f"{tuple(bias.shape)}")
    if nk < 1 or d % 64 != 0 or d > 1024:
        raise ValueError(f"masked_attention kernel needs nk >= 1 and d a "
                         f"multiple of 64 up to 1024, got nk={nk}, d={d}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"masked_attention: {name} is not contiguous")
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"masked_attention: {name} is not 16-byte "
                             "aligned")


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _launch(q, k, v, bias, scale):
    _check(q, k, v, bias)
    nq, d = q.shape
    nk = k.shape[0]
    out = torch.empty((nq, d), dtype=torch.float32, device=q.device)
    if nq == 0:
        return out
    # split the keys over blocks when the query tiles alone leave SMs idle
    # (two blocks fit on an SM)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    want = max(1, min(2 * sms // _ceil_div(nq, _BQ), _ceil_div(nk, _BK)))
    keys_per_split = _ceil_div(_ceil_div(nk, want), _BK) * _BK
    nsplit = _ceil_div(nk, keys_per_split)
    if nsplit > 1:
        part_o = torch.empty((nsplit, nq, d), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((nsplit, nq, 2), dtype=torch.float32,
                              device=q.device)
        part_o_ptr, part_ml_ptr = part_o.data_ptr(), part_ml.data_ptr()
    else:
        part_o_ptr = part_ml_ptr = None
    fn = getattr(_library(), _KERNEL_DTYPES[q.dtype])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
             out.data_ptr(), part_o_ptr, part_ml_ptr, nq, nk, d,
             float(scale), nsplit, keys_per_split, stream)
    if err != 0:
        msg = _library().hvr_cuda_error_string(err).decode()
        raise RuntimeError(f"masked_attention kernel launch failed: {msg}")
    masked_attention.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernel_build.load("masked_attention")
    ptr = ctypes.c_void_p
    for name in _KERNEL_DTYPES.values():
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float] \
            + [ctypes.c_int] * 2 + [ptr]
        fn.restype = ctypes.c_int
    lib.hvr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hvr_cuda_error_string.restype = ctypes.c_char_p
    return lib
