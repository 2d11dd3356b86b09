"""The port's CUDA kernels on the card (``gpu`` marker; each test skips
without a CUDA device), and on the CPU the limits the bf16 kernel is held to.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_port_kernels.py
"""
import numpy as np
import pytest
import torch

from hvrnet_tpu_torch.ops.attention import (NEG_INF, attention_plain,
                                            bf16_agreement, masked_attention)

torch.set_num_threads(2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(rng, nq, nk, d, masked, device="cuda"):
    q, k, v = (torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
               for n in (nq, nk, nk))
    live = np.zeros(nk, bool) if masked == "all" else rng.random(nk) > 0.2
    bias = torch.from_numpy(np.where(live, 0.0, NEG_INF).astype(np.float32))
    return [t.to(device) for t in (q, k, v, bias)]


# (nq, nk, masking): one query tile with a ragged key tile, a query count
# that splits the keys, all keys masked, and a ragged query count
@pytest.mark.gpu
@pytest.mark.parametrize("nq,nk,masked", [(5, 70, "partial"),
                                          (300, 1000, "partial"),
                                          (300, 1000, "all"),
                                          (700, 130, "partial")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernel_matches_plain(nq, nk, masked, dtype):
    """f32 within 1e-4; bf16 within the limits that rounding the softmax
    weights explains (``bf16_agreement``)."""
    _card()
    dt = getattr(torch, dtype)
    q, k, v, bias = _inputs(np.random.default_rng(nq + nk), nq, nk, 1024,
                            masked)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    before = masked_attention.launches
    got = masked_attention(q, k, v, bias, 1 / 32.)
    assert masked_attention.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (nq, 1024)
    if dt == torch.float32:
        want = attention_plain(q, k, v, bias, 1 / 32.)
        assert (got - want).abs().max().item() <= 1e-4
    else:
        _assert_bf16_agrees(got, q, k, v, bias, 1 / 32., masked == "all")


def _assert_bf16_agrees(got, q, k, v, bias, scale, all_masked):
    a = bf16_agreement(got, q, k, v, bias, scale)
    assert a["worst"] <= 1 and a["rms"] <= 1, a
    assert all_masked or a["rounds"] >= 0.1, a


def _flash_emulated(q, k, v, bias, scale, skip_rounding=False,
                    drop_tile=None):
    """The kernel's arithmetic on the CPU: key tiles of 64, a running max
    and normaliser, p rounded to bf16 against the running max before the
    product with v.  ``skip_rounding`` and ``drop_tile`` are faults the
    bf16 limits must catch."""
    s = (q.float() @ k.float().T) * scale + bias[None, :]
    m = torch.full((s.shape[0], 1), -float("inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[0], v.shape[1])
    for t in range(0, s.shape[1], 64):
        if t == drop_tile:
            continue
        m_new = torch.maximum(m, s[:, t:t + 64].max(1, keepdim=True).values)
        p = torch.exp(s[:, t:t + 64] - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(1, keepdim=True)
        if not skip_rounding:
            p = p.bfloat16().float()
        acc = acc * alpha + p @ v[t:t + 64].float()
        m = m_new
    return acc / l


@pytest.mark.parametrize("masked", ["partial", "all"])
def test_bf16_limits_pass_the_kernels_rounding(masked):
    """The limits chip_smoke.py and the card test hold the bf16 kernel to
    pass the kernel's own arithmetic, emulated on the CPU."""
    q, k, v, bias = _inputs(np.random.default_rng(3), 64, 700, 128, masked,
                            device="cpu")
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = _flash_emulated(q, k, v, bias, 128 ** -0.5)
    _assert_bf16_agrees(got, q, k, v, bias, 128 ** -0.5, masked == "all")


@pytest.mark.parametrize("fault", [dict(skip_rounding=True),
                                   dict(drop_tile=0), dict(drop_tile=320)])
def test_bf16_limits_catch_faults(fault):
    """A kernel that skips the bf16 rounding of p, or drops one key tile
    of 700, fails the limits."""
    q, k, v, bias = _inputs(np.random.default_rng(3), 64, 700, 128,
                            "partial", device="cpu")
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = _flash_emulated(q, k, v, bias, 128 ** -0.5, **fault)
    with pytest.raises(AssertionError):
        _assert_bf16_agrees(got, q, k, v, bias, 128 ** -0.5, False)


@pytest.mark.gpu
def test_attention_kernel_rejects_what_it_does_not_take():
    """On CUDA tensors the wrapper launches the kernel or raises; it never
    falls back to the plain version."""
    _card()
    q, k, v, bias = _inputs(np.random.default_rng(0), 8, 16, 128, "partial")
    before = masked_attention.launches
    bad = [(q[:, :100].contiguous(), k[:, :100].contiguous(),
            v[:, :100].contiguous(), bias),                   # d % 64 != 0
           (q, k.bfloat16(), v, bias),                         # mixed dtypes
           (q, k, v, bias.double()),                           # f64 bias
           (q, k.T.contiguous().T, v, bias),                   # strided k
           (q, k, v[:15], bias)]                               # shapes
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            masked_attention(*args, 0.1)
    assert masked_attention.launches == before
