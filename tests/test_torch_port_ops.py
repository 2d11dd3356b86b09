"""The port's ops against the JAX package's and the numpy oracles.

Same inputs, made from a seed with numpy, go through ``hvrnet_tpu.ops`` and
``hvrnet_tpu_torch.ops``: masked attention (its plain version; the Pallas
kernel runs in interpret mode), NMS (identical picks), RoIAlign, box decode
and canvas anchors.  The CUDA kernel itself runs only on the card
(``tests/test_torch_port_kernels.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hvrnet_tpu.engine.canvas import Canvas as JCanvas
from hvrnet_tpu.ops import attention as jattn
from hvrnet_tpu.ops.boxes import delta2bbox as j_delta2bbox
from hvrnet_tpu.ops.nms import multiclass_nms_static as j_multiclass_nms
from hvrnet_tpu.ops.nms import nms_static as j_nms_static
from hvrnet_tpu.ops.roi_align import roi_align as j_roi_align
from hvrnet_tpu_torch.engine.canvas import Canvas
from hvrnet_tpu_torch.ops.attention import (NEG_INF, attention_plain,
                                            masked_attention)
from hvrnet_tpu_torch.ops.boxes import delta2bbox
from hvrnet_tpu_torch.ops.nms import multiclass_nms_static, nms_static
from hvrnet_tpu_torch.ops.roi_align import roi_align
from tests.test_ops_nms import greedy_nms_np, rand_dets
from tests.test_ops_roi_align import roi_align_np

torch.set_num_threads(2)


def _attn_inputs(rng, nq, nk, d, masked):
    q = rng.normal(size=(nq, d)).astype(np.float32)
    k = rng.normal(size=(nk, d)).astype(np.float32)
    v = rng.normal(size=(nk, d)).astype(np.float32)
    if masked == "all":
        live = np.zeros(nk, bool)
    else:
        live = rng.random(nk) > 0.2            # ~20 % masked keys
    bias = np.where(live, 0.0, NEG_INF).astype(np.float32)
    return q, k, v, bias


# (d, nk, masking): D = 128 and 1024, a ragged key count (not a multiple of
# any tile), ~20 % masked keys, and an all-masked key set (every row then
# averages v)
ATTN_CASES = [(128, 130, "partial"), (1024, 130, "partial"),
              (1024, 333, "partial"), (128, 130, "all"), (1024, 77, "all")]


@pytest.mark.parametrize("d,nk,masked", ATTN_CASES)
def test_attention_plain_matches_jax_reference(d, nk, masked):
    rng = np.random.default_rng(d + nk)
    q, k, v, bias = _attn_inputs(rng, 70, nk, d, masked)
    scale = 1.0 / np.sqrt(d)
    want = np.asarray(jattn._attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        scale))
    t = [torch.from_numpy(a) for a in (q, k, v, bias)]
    got = masked_attention(*t, scale)            # CPU tensors: plain version
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.numpy(), attention_plain(*t, scale))


@pytest.mark.parametrize("d", [128, 1024])
def test_attention_plain_matches_pallas_interpret(d):
    """The Pallas TPU kernel in interpret mode (patched as
    tests/test_attention.py does) with a ragged key count that its host pads
    to the key tile."""
    import jax.experimental.pallas as pl
    rng = np.random.default_rng(7 + d)
    q, k, v, bias = _attn_inputs(rng, 40, 150, d, "partial")
    scale = 1.0 / np.sqrt(d)
    orig = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    pl.pallas_call = interp_call
    try:
        want = np.asarray(jattn._flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(bias), scale, tq=32, tk=64))
    finally:
        pl.pallas_call = orig
    got = attention_plain(*[torch.from_numpy(a) for a in (q, k, v, bias)],
                          scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_attention_plain_bf16_matches_jax_reference():
    """bf16 inputs: both round the softmax weights to bf16 before the
    product with v; a weight whose f32 softmax differs by one ulp can round
    to a neighbouring bf16 value, so the bound is one bf16 ulp (2^-8
    relative) of the weights times max|v|."""
    rng = np.random.default_rng(3)
    q, k, v, bias = _attn_inputs(rng, 48, 200, 128, "partial")
    scale = 1.0 / np.sqrt(128)
    bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jattn._attention_reference(*bf, jnp.asarray(bias),
                                                 scale))
    tb = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    got = attention_plain(*tb, torch.from_numpy(bias), scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2.0 ** -8 * np.abs(v).max())


def _tied_dets(rng, n):
    """Random boxes whose scores repeat (rounded to one decimal), so the
    pick order depends on the tie rule."""
    boxes, scores = rand_dets(rng, n)
    return boxes, np.round(scores, 1).astype(np.float32)


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, True)])
def test_nms_static_identical_to_jax(seed, ties):
    rng = np.random.default_rng(seed)
    boxes, scores = (_tied_dets if ties else rand_dets)(rng, 300)
    valid = rng.random(300) > 0.1
    for max_out, thr in ((50, 0.5), (300, 0.7)):
        ji, jm = j_nms_static(jnp.asarray(boxes), jnp.asarray(scores), thr,
                              max_out, valid=jnp.asarray(valid))
        ti, tm = nms_static(torch.from_numpy(boxes), torch.from_numpy(scores),
                            thr, max_out, valid=torch.from_numpy(valid))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(ti.numpy()[tm.numpy()],
                                      np.asarray(ji)[np.asarray(jm)])
        if not ties:      # the oracle's argsort has no defined tie order
            vi = np.flatnonzero(valid)
            want = vi[greedy_nms_np(boxes[vi], scores[vi], thr)][:max_out]
            np.testing.assert_array_equal(ti.numpy()[tm.numpy()], want)


@pytest.mark.parametrize("seed,ties", [(3, False), (4, True)])
def test_multiclass_nms_identical_to_jax(seed, ties):
    rng = np.random.default_rng(seed)
    n, ncls = 120, 6
    boxes, _ = rand_dets(rng, n)
    logits = rng.normal(size=(n, ncls)).astype(np.float32)
    if ties:
        logits = np.round(logits, 0)
    scores = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    scores = scores.astype(np.float32)
    valid = rng.random(n) > 0.1
    jd, jl, jm = j_multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                  0.05, 0.3, 40, valid=jnp.asarray(valid))
    td, tl, tm = multiclass_nms_static(torch.from_numpy(boxes),
                                       torch.from_numpy(scores), 0.05, 0.3,
                                       40, valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_roi_align_matches_jax_and_oracle():
    rng = np.random.default_rng(5)
    H, W, C = 12, 17, 8
    feats = rng.normal(size=(1, H, W, C)).astype(np.float32)
    xy1 = rng.uniform(-20, 220, size=(24, 2))
    wh = rng.uniform(1, 120, size=(24, 2))
    rois = np.concatenate([np.zeros((24, 1)), xy1, xy1 + wh], 1)
    rois = rois.astype(np.float32)
    want_j = np.asarray(j_roi_align(jnp.asarray(feats), jnp.asarray(rois),
                                    7, 1 / 16., 2))
    want_np = roi_align_np(feats, rois, 7, 1 / 16., 2)
    got = roi_align(torch.from_numpy(feats.transpose(0, 3, 1, 2)).contiguous(),
                    torch.from_numpy(rois), 7, 1 / 16., 2)
    got = got.numpy().transpose(0, 2, 3, 1)          # (R, C, 7, 7) → NHWC
    np.testing.assert_allclose(got, want_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want_np, rtol=0, atol=1e-5)


def test_delta2bbox_and_canvas_anchors_match_jax():
    rng = np.random.default_rng(6)
    jc, tc = JCanvas(96, 128), Canvas(96, 128)
    np.testing.assert_array_equal(tc.anchors.numpy(), np.asarray(jc.anchors))
    for pad in ((96, 128), (80, 100), (61, 33)):
        np.testing.assert_array_equal(
            tc.anchor_valid(np.array(pad, np.float32)).numpy(),
            np.asarray(jc.anchor_valid(jnp.asarray(pad, jnp.float32))))
    rois = np.array(jc.anchors)[:200]
    deltas = rng.normal(size=(200, 4)).astype(np.float32)
    shape = np.array([90.0, 120.0], np.float32)
    for means, stds in (((0.,) * 4, (1.,) * 4),
                        ((0.,) * 4, (0.1, 0.1, 0.2, 0.2))):
        want = np.asarray(j_delta2bbox(jnp.asarray(rois), jnp.asarray(deltas),
                                       means, stds, jnp.asarray(shape)))
        got = delta2bbox(torch.from_numpy(rois), torch.from_numpy(deltas),
                         means, stds, shape)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
