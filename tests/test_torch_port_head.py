"""The port's weights and HRNMP window head against the JAX package's.

Weights cross with ``state_dict_from_jax`` (key set, shapes, and a round
trip through the JAX ``convert_torch_checkpoint``).  The head runs on random
fc1 rows, boxes and masks, as ``tests/test_attention.py`` drives
``window_detect``: NL1..NL4, the fc3 splice, both branches, then decode and
class-wise NMS.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hvrnet_tpu.utils.checkpoint import convert_torch_checkpoint, merge_params
from hvrnet_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_port_backbone import jax_param_tree, shared_engines

torch.set_num_threads(2)

T, P, D = 3, 8, 1024
ISH = np.array([86.0, 118.0], np.float32)
SF = np.array([1.25, 1.25, 1.25, 1.25], np.float32)


@pytest.fixture(scope="module")
def engines():
    return shared_engines(seed=1)


def _window_inputs(seed):
    rng = np.random.default_rng(seed)
    fc1 = rng.normal(size=(T, P, D)).astype(np.float32)
    xy = rng.random((T, P, 2)) * 40
    boxes = np.concatenate([xy, xy + 10 + rng.random((T, P, 2)) * 40],
                           axis=-1).astype(np.float32)
    masks = rng.random((T, P)) < 0.85
    return fc1, boxes, masks


def test_state_dict_from_jax_key_set_and_round_trip(engines):
    jeng, _, port = engines
    tree = jax_param_tree(jeng, seed=5)
    sd = state_dict_from_jax(tree)
    want = port.model.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert v.shape == want[k].shape, k
    back = convert_torch_checkpoint({k: v.numpy() for k, v in sd.items()})
    merged, missing = merge_params(tree["params"], back["params"])
    assert missing == []
    flat = jax.tree_util.tree_leaves_with_path(tree["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(got) == len(flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(got[path], np.asarray(leaf))


def test_reference_checkpoint_names_load(engines):
    """A reference BatchNorm2d state_dict also carries num_batches_tracked;
    the frozen BNs accept and drop it."""
    _, _, port = engines
    sd = dict(port.model.state_dict())
    for k in [k for k in sd if k.endswith(".running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    port.load_state_dict(sd)


def test_forward_fc1_matches_jax(engines):
    """Branch (NL2) and final (NL4) logits and deltas of the key rows."""
    jeng, params, port = engines
    fc1, _, masks = _window_inputs(0)
    kd = jeng.key_dim
    mod = jeng.module
    cls_j, reg_j = mod.apply(jeng._bb(params), jnp.asarray(fc1.reshape(T * P, D)),
                             kd * P, P, jnp.asarray(masks.reshape(-1)),
                             method=mod.bbox_forward_fc1)
    with torch.no_grad():
        cls_t, reg_t = port.model.bbox_head.forward_fc1(
            torch.from_numpy(fc1.reshape(T * P, D)), kd * P, P,
            torch.from_numpy(masks.reshape(-1)))
    for a, b in zip(cls_t + reg_t, list(cls_j) + list(reg_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_window_detect_matches_jax(engines, seed):
    """Both branches decoded: identical labels and masks, boxes within
    1e-3 px, scores within 1e-4."""
    jeng, params, port = engines
    fc1, boxes, masks = _window_inputs(seed)
    want = jax.device_get(jeng.window_detect(
        params, jnp.asarray(fc1), jnp.asarray(boxes), jnp.asarray(masks),
        ISH, SF))
    got = port.window_detect(torch.from_numpy(fc1), torch.from_numpy(boxes),
                             torch.from_numpy(masks), ISH, SF)
    assert len(got) == len(want) == 2
    for (td, tl, tm), (jd, jl, jm) in zip(got, want):
        np.testing.assert_array_equal(tm.numpy(), jm)
        np.testing.assert_array_equal(tl.numpy()[jm], jl[jm])
        np.testing.assert_allclose(td.numpy()[:, :4], jd[:, :4], rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(td.numpy()[:, 4], jd[:, 4], rtol=0,
                                   atol=1e-4)
        assert jm.sum() > 0
