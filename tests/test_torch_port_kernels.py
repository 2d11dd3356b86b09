"""The port's CUDA kernels on the card (``gpu`` marker; each test skips
without a CUDA device), the streaming ring's head on the card against the
exact head, and on the CPU the kernel's arithmetic emulated:
the limits the bf16 kernel is held to, the 3xTF32 accuracy of the f32
path, and the split of the keys over blocks.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_port_kernels.py
"""
import numpy as np
import pytest
import torch

from hvrnet_tpu_torch.ops.attention import (_KEYS_PER_STAGE, _TILE_US,
                                            NEG_INF, _choose_split,
                                            attention_plain,
                                            bf16_agreement, masked_attention,
                                            plan)

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


# (nq, nk, masking): one query tile with a ragged key tile and nq below one
# warpgroup's 64 rows, query counts whose output splits the keys over
# blocks (300 × 1000, and 300 × 6300 as at NL2/NL4, whose logits take the
# 64 × 256 block), all keys masked, a ragged query count, nq and nk that
# are not multiples of 128, a key count that leaves the last 64 × 256
# block's second half without keys (300 × 6200), and NL2/NL4 at the
# 63-frame cache (300 × 18 900)
@pytest.mark.gpu
@pytest.mark.parametrize("nq,nk,masked", [(5, 70, "partial"),
                                          (40, 200, "partial"),
                                          (300, 1000, "partial"),
                                          (300, 1000, "all"),
                                          (700, 130, "partial"),
                                          (200, 333, "partial"),
                                          (300, 6300, "partial"),
                                          (300, 6200, "partial"),
                                          (300, 18900, "partial")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernel_matches_plain(nq, nk, masked, dtype):
    """f32 within 1e-4 and within 1e-5 of max|plain| (3xTF32 keeps f32
    accuracy; single-pass TF32 would not); bf16 within the limits that
    rounding the softmax weights explains (``bf16_agreement``)."""
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
        err = (got - want).abs().max().item()
        assert err <= 1e-4
        assert err <= 1e-5 * want.abs().max().item()
    else:
        _assert_bf16_agrees(got, q, k, v, bias, 1 / 32., masked == "all")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernel_is_deterministic(dtype):
    """No atomics: two calls on the same inputs give the same bits, and so
    does the same call run phase by phase."""
    _card()
    dt = getattr(torch, dtype)
    q, k, v, bias = _inputs(np.random.default_rng(1), 300, 6300, 1024,
                            "partial")
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    first = masked_attention(q, k, v, bias, 1 / 32.)
    assert torch.equal(first, masked_attention(q, k, v, bias, 1 / 32.))
    call = plan(q, k, v, bias, 1 / 32.)
    for _, phase in call.phases:
        phase()
    assert torch.equal(first, call.out)


def _assert_bf16_agrees(got, q, k, v, bias, scale, all_masked):
    a = bf16_agreement(got, q, k, v, bias, scale)
    assert a["worst"] <= 1 and a["rms"] <= 1, a
    assert all_masked or a["rounds"] >= 0.1, a


def _tf32(x):
    """Round float32 to tf32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero, keeping 10 mantissa bits (through the int32 view)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _matmul_3xtf32(a, b):
    """a·bᵀ as the kernel forms it from f32 operands: each split into
    hi = tf32(x) and lo = tf32(x − hi), and hi·hi + hi·lo + lo·hi summed
    (exact products, rounded to f32 once)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    d = torch.float64
    return (a_lo.to(d) @ b_hi.to(d).T + a_hi.to(d) @ b_lo.to(d).T
            + a_hi.to(d) @ b_hi.to(d).T).float()


def _matmul_tf32(a, b):
    """a·bᵀ in single-pass TF32, the precision the kernel must not fall
    to."""
    return (_tf32(a).double() @ _tf32(b).double().T).float()


def _kernel_emulated(q, k, v, bias, scale, matmul=None, key_tile=64,
                     nsplit=3, skip_rounding=False, drop_tile=None,
                     drop_split=None):
    """The kernel's arithmetic on the CPU.  Pass 1: S = scale·q·kᵀ + bias,
    and per 128-key tile its max and Σ exp(s − max); statistics: the row
    max m and l = Σ_t exp(m_t − m)·l_t; pass 2: P = exp(S − m) (rounded to
    bf16 for bf16 inputs), P·v summed over ``key_tile`` keys at a time in
    ``nsplit`` splits of whole tiles, the split partials added in order and
    divided by l.  ``matmul`` forms the products (plain f32 by default).
    ``skip_rounding``, ``drop_tile`` (a key tile left out of P·v) and
    ``drop_split`` (one split's partial lost) are faults the bf16 limits
    must catch."""
    matmul = matmul or (lambda a, b: a.float() @ b.float().T)
    nk = k.shape[0]
    s = matmul(q.float(), k.float()) * scale + bias[None, :]
    tiles = s.split(128, dim=1)
    tile_m = torch.stack([t.max(1).values for t in tiles], 1)
    tile_l = torch.stack([torch.exp(t - tm[:, None]).sum(1)
                          for t, tm in zip(tiles, tile_m.T)], 1)
    m = tile_m.max(1).values
    l = (torch.exp(tile_m - m[:, None]) * tile_l).sum(1)
    p = torch.exp(s - m[:, None])
    if q.dtype == torch.bfloat16 and not skip_rounding:
        p = p.bfloat16().float()
    ntiles = -(-nk // key_tile)
    per = -(-ntiles // nsplit)
    out = torch.zeros(q.shape[0], v.shape[1])
    for split, t0 in enumerate(range(0, ntiles, per)):
        part = torch.zeros_like(out)
        for t in range(t0, min(ntiles, t0 + per)):
            if t != drop_tile:
                keys = slice(t * key_tile, (t + 1) * key_tile)
                part += matmul(p[:, keys], v[keys].float().T)
        if split != drop_split:
            out += part
    return out / l[:, None]


@pytest.mark.parametrize("masked", ["partial", "all"])
def test_bf16_limits_pass_the_kernels_rounding(masked):
    """The limits chip_smoke.py and the card test hold the bf16 kernel to
    pass the kernel's own arithmetic, emulated on the CPU."""
    q, k, v, bias = _inputs(np.random.default_rng(3), 64, 700, 128, masked,
                            device="cpu")
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = _kernel_emulated(q, k, v, bias, 128 ** -0.5)
    _assert_bf16_agrees(got, q, k, v, bias, 128 ** -0.5, masked == "all")


@pytest.mark.parametrize("fault", [dict(skip_rounding=True),
                                   dict(drop_tile=0), dict(drop_tile=5),
                                   dict(drop_split=1)])
def test_bf16_limits_catch_faults(fault):
    """A kernel that skips the bf16 rounding of p, drops one 64-key tile of
    700, or loses one split's partial sum fails the limits."""
    q, k, v, bias = _inputs(np.random.default_rng(3), 64, 700, 128,
                            "partial", device="cpu")
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = _kernel_emulated(q, k, v, bias, 128 ** -0.5, **fault)
    with pytest.raises(AssertionError):
        _assert_bf16_agrees(got, q, k, v, bias, 128 ** -0.5, False)


def test_3xtf32_keeps_f32_accuracy_and_single_tf32_does_not():
    """The f32 kernel's arithmetic (3xTF32 in both passes, 32-key tiles,
    split partials) at 64 × 700 × 1024 stays within 1e-5 of max|plain|, the
    relative limit chip_smoke.py and the card test apply; single-pass TF32
    comes out at least 10× worse, so the limit tells the two apart."""
    q, k, v, bias = _inputs(np.random.default_rng(5), 64, 700, 1024,
                            "partial", device="cpu")
    scale = 1024 ** -0.5
    want = attention_plain(q, k, v, bias, scale)
    ref = want.abs().max().item()
    err3 = (_kernel_emulated(q, k, v, bias, scale, _matmul_3xtf32, 32)
            - want).abs().max().item() / ref
    err1 = (_kernel_emulated(q, k, v, bias, scale, _matmul_tf32, 32)
            - want).abs().max().item() / ref
    assert err3 <= 1e-5, err3
    assert err1 >= 10 * 1e-5 and err1 >= 10 * err3, (err1, err3)


@pytest.mark.parametrize("nq,nk,dtype", [(6300, 6300, torch.float32),
                                         (300, 6300, torch.float32),
                                         (300, 6300, torch.bfloat16),
                                         (5, 70, torch.float32),
                                         (700, 130, torch.bfloat16)])
def test_output_split_covers_every_key_tile(nq, nk, dtype):
    """The output phase's split of the keys over blocks covers every key
    tile once, leaves no split empty, and at NL2/NL4 (24 output tiles)
    spreads over at least four splits."""
    keys = _KEYS_PER_STAGE[dtype]
    ktiles = -(-nk // keys)
    tiles = -(-nq // 128) * 8
    nsplit, per = _choose_split(tiles, ktiles, 132, _TILE_US[dtype],
                                nq * 1024 * 4 / 2.5e6)
    assert per * nsplit >= ktiles > per * (nsplit - 1)
    if (nq, nk) == (300, 6300):
        assert nsplit >= 4


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


@pytest.mark.gpu
def test_streaming_head_matches_exact_head_on_the_card():
    """The streaming ring on the card (T = 5, 64 proposals, d = 1024, 12
    slides): ``stream_forward``'s logits within 1e-3 of ``forward_fc1`` on
    the same window (relative to max(|ref|, 1)), with 2 kernel launches
    against the exact head's 4, a clear health verdict, and the same after
    ``stream_rebuild``."""
    _card()
    from hvrnet_tpu_torch.engine.detector import f32_precision, init_weights
    from hvrnet_tpu_torch.models.bbox_heads.hrnmp_bbox_head import \
        HRNMPBBoxHead
    t, p, d, kd = 5, 64, 1024, 2
    head = HRNMPBBoxHead(sampler_num=p, t_dim=t, in_channels=16).eval()
    init_weights(head, 0)
    head.cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = dict(device="cuda")
    st = dict(mask=torch.zeros((t, p), dtype=torch.bool, **dev),
              M1=torch.full((t * p, t), -torch.inf, **dev),
              M3=torch.full((t * p, t), -torch.inf, **dev))
    for name in ("fc1", "q1", "k1", "fc3s", "q3", "k3", "a1", "a3"):
        st[name] = torch.zeros((t * p, d), **dev)
    for name in ("1", "3"):
        st["m" + name] = torch.full((t * p,), -torch.inf, **dev)
        st["l" + name] = torch.zeros((t * p,), **dev)
    window = []
    with torch.no_grad(), f32_precision():
        for i in range(12):
            fc1 = torch.randn((p, d), generator=gen, **dev)
            mask = torch.rand((p,), generator=gen, **dev) > 0.2
            _, bad = head.stream_update(st, fc1, mask, i % t, rollback=True)
            window = (window + [(fc1, mask)])[-t:]
        assert not bool(bad)
        centre = (11 + 1 + kd) % t
        want = head.forward_fc1(torch.cat([f for f, _ in window]), kd * p, p,
                                torch.cat([m for _, m in window]))
        for rebuilt in (False, True):
            if rebuilt:
                head.stream_rebuild(st)
            before = masked_attention.launches
            cls, reg, bad = head.stream_forward(st, centre, rollback=True)
            assert masked_attention.launches == before + 2
            assert not bool(bad)
            for g, w in zip(cls + reg, want[0] + want[1]):
                scale = max(w.abs().max().item(), 1.0)
                assert (g - w).abs().max().item() <= 1e-3 * scale, rebuilt
