"""Masked attention: ``softmax(q·kᵀ·scale + bias)·v`` → (nq, d) float32,
or (B, nq, d) over B independent lanes (one per video stream).

Counterpart of ``hvrnet_tpu/ops/attention.py:masked_attention``.  On a CUDA
tensor it launches the hand-written Hopper kernel
(``csrc/masked_attention.cu``, which replaces the Pallas ``_flash_kernel``):
five phases on the tensor cores (pre-split, logits, row statistics, output,
combine) whose scratch this module allocates; on a CPU tensor it runs
``attention_plain``, the straightforward expression that the tests and
``chip_smoke.py`` hold the kernel against.

``bias`` is 0 for live keys and −1e30 for masked ones.  A leading lane
axis on q (B, nq, d), k and v (B, nk, d) and bias (B, nk) is one kernel
launch for all lanes (the counterpart of ``jax.vmap`` over the Pallas
call, whose batching rule adds a grid axis); each lane keeps its own keys
and mask.  Inputs are float32
or bfloat16; logits, softmax and accumulation are float32 (float32 inputs
as 3xTF32 on the tensor cores); with bfloat16 inputs the softmax weights
are rounded to bfloat16 before the product with v.  (The plain versions
keep float64 inputs in float64, for gradient checks.)

``masked_attention`` is differentiable: a ``torch.autograd.Function`` whose
forward is the kernel (or the plain version on the CPU) and whose backward
is ``attention_backward_plain``, the dense recompute of the JAX package's
``custom_vjp`` backward ``_bwd`` (which is XLA, not a Pallas kernel).

``masked_attention_kv_sharded`` splits the keys over several devices
(sequence parallelism for windows beyond one card); its shard body is plain
PyTorch, as the JAX one is XLA, and launches no kernel.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Sequence

import torch

from . import kernel_build

NEG_INF = -1e30

_BM, _BN = 128, 128        # the kernels' query rows and columns per block
_KEYS_PER_STAGE = {torch.float32: 32, torch.bfloat16: 64}   # pass 2
# µs one output block of pass 2 spends on one stage of keys (H100 80GB HBM3
# at 700 W, chip_smoke.py's NL1 pass-2 times of the first tensor-core
# version); only their ratio to the combine's traffic steers the split
_TILE_US = {torch.float32: 1.2, torch.bfloat16: 1.05}


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """float32, or float64 for float64 inputs."""
    return torch.promote_types(t.dtype, torch.float32)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, scale: float) -> torch.Tensor:
    """The plain version: (nq, nk) logits, softmax, product with v (batched
    products under a leading lane axis)."""
    f = _acc_dtype(q)
    aff = ((q.to(f) @ k.to(f).transpose(-1, -2)) * scale
           + bias.to(f)[..., None, :])
    w = torch.softmax(aff, dim=-1)
    return w.to(v.dtype).to(f) @ v.to(f)


def attention_backward_plain(q, k, v, bias, scale: float, g):
    """(dq, dk, dv, dbias) of ``attention_plain`` for the output cotangent
    ``g``: the recompute of ``hvrnet_tpu/ops/attention.py:_bwd`` line for
    line, in float32 (float64 for float64 inputs), each cast back to its
    input's dtype.  Like ``_bwd``, ``dbias`` sums the scaled logit gradient
    ``ds``, so it carries a factor ``scale``; nothing differentiates the
    mask bias."""
    f = _acc_dtype(q)
    qf, kf, vf = q.to(f), k.to(f), v.to(f)
    aff = qf @ kf.transpose(-1, -2) * scale + bias.to(f)[..., None, :]
    w = torch.softmax(aff, dim=-1)
    g = g.to(f)
    dv = w.transpose(-1, -2) @ g
    dw = g @ vf.transpose(-1, -2)
    tmp = (dw * w).sum(dim=-1, keepdim=True)
    ds = w * (dw - tmp) * scale
    dq = (ds @ kf).to(q.dtype)
    dk = (ds.transpose(-1, -2) @ qf).to(k.dtype)
    dbias = ds.sum(dim=-2).to(bias.dtype)
    return dq, dk, dv.to(v.dtype), dbias


def bf16_agreement(got: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, bias: torch.Tensor, scale: float) -> dict:
    """How far ``got``, the kernel's output on bfloat16 inputs, lies from
    ``attention_plain``'s, in units of what rounding the softmax weights to
    bfloat16 explains.  Both versions round each weight w_j with relative
    error ≤ u = 2^-8 (the kernel p_j against its row max, the plain
    version w_j after normalising), so the difference Δ obeys:

    * ``worst`` = max |Δ| / (2u·Σ_j w_j·|v_j|) ≤ 1, elementwise;
    * ``rms`` = rms(Δ) / (u·R), R² = mean of Σ_j w_j²·v_j²: independent
      roundings give ≈ 0.6, so ≤ 1 holds with margin (rows of near-equal
      weights, whose p_j share a value and round alike, are not
      independent: there only ``worst`` bounds Δ);
    * ``rounds`` = rms(got − w·v) / (u·R): the kernel's own rounding leaves
      ≈ 0.4 between it and the unrounded product, and a kernel that skips
      the rounding ≈ 1e-4.  (With every key masked the weights are exactly 1
      in the kernel and nothing rounds.)
    """
    vf = v.float()
    w = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * scale
                      + bias.float()[..., None, :], dim=-1)
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


class _MaskedAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        if q.device.type == "cpu":
            return attention_plain(q, k, v, bias, scale)
        if q.device.type != "cuda":
            raise ValueError(f"masked_attention: unsupported device "
                             f"{q.device}")
        return _launch(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, g):
        grads = attention_backward_plain(*ctx.saved_tensors, ctx.scale, g)
        return tuple(d if need else None for d, need in
                     zip(grads, ctx.needs_input_grad)) + (None,)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, scale: float) -> torch.Tensor:
    """q: (nq, d); k, v: (nk, d); bias: (nk,) float32 → (nq, d) float32;
    or the same with a leading lane axis B on all four → (B, nq, d).

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``masked_attention.launches``, one per call whatever
    B) or raise.  Gradients
    reach q, k, v and bias through ``attention_backward_plain``."""
    return _MaskedAttention.apply(q, k, v, bias, scale)


masked_attention.launches = 0
# lane replicas launch from several host threads (parallel/lanes.py)
_LAUNCHES_LOCK = threading.Lock()


def pad_keys(k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, n: int):
    """K, V and the bias padded along the key axis to a multiple of ``n``:
    zero keys and values with a −1e30 bias, which no softmax weight
    reaches (the JAX head's padding before ``masked_attention_kv_sharded``)."""
    pad = (-k.shape[-2]) % n
    if not pad:
        return k, v, bias
    zeros = k.new_zeros(k.shape[:-2] + (pad, k.shape[-1]))
    return (torch.cat([k, zeros], dim=-2), torch.cat([v, zeros], dim=-2),
            torch.cat([bias, bias.new_full(bias.shape[:-1] + (pad,),
                                           NEG_INF)], dim=-1))


def masked_attention_kv_sharded(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, bias: torch.Tensor,
                                scale: float, devices: Sequence
                                ) -> torch.Tensor:
    """``attention_plain`` with K, V and the bias split along the key axis
    into ``len(devices)`` equal shards, shard i on ``devices[i]`` (a device
    may repeat) and q on each (counterpart of
    ``hvrnet_tpu/ops/attention.py:masked_attention_kv_sharded``): each
    shard's scaled float32 logits and their row max; the row max of those
    (the ``pmax``); each shard's ``exp(logits − max)``, its row sum and its
    product with v, the weights cast to v's dtype first (the JAX
    ``p.astype(v.dtype)``); the sums added on q's device (the ``psum``) and
    divided.  No device holds more than its shard's (nq, nk / n) logits.
    The key count must divide by the shard count (``pad_keys``).  q (nq, d)
    or (B, nq, d), k and v (…, nk, d), bias (…, nk) → float32 (float64 for
    float64 inputs) on q's device."""
    n = len(devices)
    nk = k.shape[-2]
    if nk % n:
        raise ValueError(f"{nk} keys do not split into {n} shards: pad "
                         f"them (pad_keys)")
    per = nk // n
    f = _acc_dtype(q)
    home = q.device
    shards = []
    for i, dev in enumerate(devices):
        keys = slice(i * per, (i + 1) * per)
        kd = k[..., keys, :].to(dev)
        aff = ((q.to(dev).to(f) @ kd.to(f).transpose(-1, -2)) * scale
               + bias[..., keys].to(dev).to(f)[..., None, :])
        shards.append((aff, v[..., keys, :].to(dev)))
    m = torch.stack([aff.amax(dim=-1, keepdim=True).to(home)
                     for aff, _ in shards]).amax(dim=0)
    num = den = 0
    for aff, vd in shards:
        p = torch.exp(aff - m.to(aff.device))
        num = num + (p.to(vd.dtype).to(f) @ vd.to(f)).to(home)
        den = den + p.sum(dim=-1, keepdim=True).to(home)
    return num / den


_MAX_LANES = 64          # the kernel's lane grid axis (gridDim.z)


def _check(q, k, v, bias):
    if q.dim() not in (2, 3):
        raise ValueError(f"masked_attention takes q (nq, d) or (B, nq, d), "
                         f"got {tuple(q.shape)}")
    lead = tuple(q.shape[:-2])
    nq, d = q.shape[-2:]
    nk = k.shape[-2] if k.dim() == q.dim() else -1
    for name, t in (("k", k), ("v", v), ("bias", bias)):
        if t.device != q.device:
            raise ValueError(f"masked_attention: {name} on {t.device}, "
                             f"q on {q.device}")
    if q.dtype not in _KEYS_PER_STAGE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError("masked_attention kernel takes q, k, v all float32 "
                        f"or all bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"masked_attention bias must be float32, "
                        f"got {bias.dtype}")
    if tuple(k.shape) != lead + (nk, d) or tuple(v.shape) != lead + (nk, d) \
            or tuple(bias.shape) != lead + (nk,):
        raise ValueError(f"masked_attention shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, bias "
                         f"{tuple(bias.shape)}")
    if nk < 1 or d % 64 != 0 or d > 1024:
        raise ValueError(f"masked_attention kernel needs nk >= 1 and d a "
                         f"multiple of 64 up to 1024, got nk={nk}, d={d}")
    if lead and not 1 <= lead[0] <= _MAX_LANES:
        raise ValueError(f"masked_attention kernel takes 1 to {_MAX_LANES} "
                         f"lanes, got {lead[0]}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"masked_attention: {name} is not contiguous")
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"masked_attention: {name} is not 16-byte "
                             "aligned")


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _ceil_div(a, b) * b


@functools.lru_cache(maxsize=256)
def _choose_split(tiles: int, ktiles: int, sms: int, tile_us: float,
                  split_us: float) -> tuple[int, int]:
    """(nsplit, k-tiles per split) for the output phase: its ``tiles``
    output tiles times nsplit blocks run in waves of ``sms``, each block for
    its k-tiles (about ``tile_us`` each, plus two for its prologue and
    epilogue), and every split costs the combine ``split_us`` of traffic."""
    best = None
    for want in range(1, min(ktiles, 32) + 1):
        per = _ceil_div(ktiles, want)
        nsplit = _ceil_div(ktiles, per)
        cost = (_ceil_div(tiles * nsplit, sms) * (per + 2) * tile_us
                + (nsplit > 1) * (nsplit + 1) * split_us)
        if best is None or cost < best[0]:
            best = (cost, nsplit, per)
    return best[1], best[2]


PHASES = ("pre-split", "pass 1", "statistics", "pass 2", "combine")


class _Call:
    """One kernel call's arguments and workspace: ``run(first, last)``
    launches phases ``PHASES[first..last]`` on the inputs' device (made
    current for the launch, whatever the calling thread's current device)
    and its current stream.  Lanes multiply the output tiles the split is
    chosen for and every scratch buffer; a 2-D call is one lane."""

    def __init__(self, q, k, v, bias, scale):
        nq, d = q.shape[-2:]
        nk = k.shape[-2]
        lanes = q.shape[0] if q.dim() == 3 else 1
        f32 = q.dtype == torch.float32
        dev = q.device
        sms = _sm_count(dev.index if dev.index is not None
                        else torch.cuda.current_device())
        self.nsplit, per = _choose_split(
            lanes * _ceil_div(nq, _BM) * _ceil_div(d, _BN),
            _ceil_div(nk, _KEYS_PER_STAGE[q.dtype]), sms,
            _TILE_US[q.dtype], lanes * nq * d * 4 / 2.5e6)
        lib = _library()
        nbytes = lib.hvr_attn_workspace_bytes(int(f32), lanes, nq, nk, d,
                                              self.nsplit)
        self.out = torch.empty(q.shape[:-1] + (d,), dtype=torch.float32,
                               device=dev)
        self.workspace = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        self._args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      bias.data_ptr(), self.out.data_ptr(),
                      self.workspace.data_ptr(), lanes, nq, nk, d,
                      float(scale), self.nsplit, per,
                      torch.cuda.current_stream(dev).cuda_stream)
        self._f32 = int(f32)
        self._device = dev

    def run(self, first: int = 0, last: int = len(PHASES) - 1) -> torch.Tensor:
        with torch.cuda.device(self._device):
            err = _library().hvr_attn_run(self._f32, first, last, *self._args)
        if err != 0:
            msg = _library().hvr_attn_error_string(err).decode()
            raise RuntimeError(f"masked_attention kernel launch failed: {msg}")
        return self.out

    @property
    def phases(self):
        """``(name, fn)`` for each phase this call runs, in order; ``fn``
        reruns that phase alone (after the phases before it have run)."""
        names = PHASES if self.nsplit > 1 else PHASES[:-1]
        return [(name, functools.partial(self.run, i, i))
                for i, name in enumerate(names)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(q, k, v, bias, scale) -> _Call:
    """A checked call on CUDA tensors that has not run yet, for timing its
    phases; ``plan(...).run()`` computes what ``masked_attention`` returns
    (without counting a launch)."""
    _check(q, k, v, bias)
    return _Call(q, k, v, bias, scale)


def _launch(q, k, v, bias, scale):
    _check(q, k, v, bias)
    if q.shape[-2] == 0:
        return torch.empty(q.shape, dtype=torch.float32, device=q.device)
    out = _Call(q, k, v, bias, scale).run()
    with _LAUNCHES_LOCK:
        masked_attention.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernel_build.load("masked_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hvr_attn_workspace_bytes.argtypes = [i32] * 6
    lib.hvr_attn_workspace_bytes.restype = ctypes.c_longlong
    lib.hvr_attn_run.argtypes = ([i32] * 3 + [ptr] * 6 + [i32] * 4
                                 + [ctypes.c_float] + [i32] * 2 + [ptr])
    lib.hvr_attn_run.restype = i32
    lib.hvr_attn_error_string.argtypes = [i32]
    lib.hvr_attn_error_string.restype = ctypes.c_char_p
    return lib
