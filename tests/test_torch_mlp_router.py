"""K2's module, presight_tpu_torch.ops.mlp, and the expert router
(presight_tpu_torch.fields.router) against the JAX package.

Tolerances: routing maps (to_slot, from_slot, block_expert, ...) exact; MLP
outputs rtol 1e-5, atol 1e-5 (f32 matmul sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presight_tpu.fields import router as JR
from presight_tpu.ops import mlp as JM
from presight_tpu_torch.fields import router as TR
from presight_tpu_torch.ops import mlp as TM


def _t(a):
    return torch.from_numpy(np.array(a))


def _layers(key, in_dim, num_layers, width, out_dim, num_experts):
    # jitted: one compile instead of one per operation
    params = jax.jit(lambda k: JM.init_mlp(k, in_dim, num_layers, width, out_dim,
                                           num_experts))(key)
    np_params = [(np.asarray(w), np.asarray(b)) for w, b in params]
    return params, [(_t(w), _t(b)) for w, b in np_params]


def test_assign_experts_matches_jax_first_index_on_ties():
    rng = np.random.RandomState(0)
    cent = np.array([[0, 0, 0], [2, 0, 0], [0, 2, 0], [2, 2, 0]], np.float32)
    pos = np.concatenate([
        rng.randn(500, 3) * 2,
        # equidistant from two or four centroids
        np.array([[1, 0, 0], [1, 1, 0], [0, 1, 0], [1, 1, 5], [2, 1, 0]]),
    ]).astype(np.float32)
    ref = np.asarray(JR.assign_experts(jnp.asarray(pos), jnp.asarray(cent)))
    out = TR.assign_experts(_t(pos), _t(cent))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out[-5:].tolist() == [0, 0, 0, 0, 1]


@pytest.mark.parametrize("num_experts,block", [(4, 8), (5, 16), (1, 8)])
def test_routing_maps_match_jax_exactly(num_experts, block):
    rng = np.random.RandomState(num_experts)
    # expert 1 left empty when there are several, to exercise empty slabs
    eids = rng.randint(0, num_experts, 203).astype(np.int32)
    if num_experts > 2:
        eids[eids == 1] = 2
    ref = JR.build_routing(jnp.asarray(eids), num_experts)
    out = TR.build_routing(_t(eids), num_experts)
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    ref_p = JR.build_padded_routing(jnp.asarray(eids), num_experts, block)
    out_p = TR.build_padded_routing(_t(eids), num_experts, block)
    for name in ref_p._fields:
        np.testing.assert_array_equal(getattr(out_p, name).numpy(),
                                      np.asarray(getattr(ref_p, name)), err_msg=name)
    # pad -> unpad is the identity; padding slots hold zeros, as in JAX
    x = rng.randn(203, 5).astype(np.float32)
    padded = TR.pad_rows(_t(x), out_p)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(JR.pad_rows(jnp.asarray(x), ref_p)))
    np.testing.assert_array_equal(TR.unpad_rows(padded, out_p).numpy(), x)


def test_blocked_layout_matches_jax_exactly():
    sizes = np.array([5, 0, 17, 8], np.int32)
    ref = JM._blocked_layout(jnp.asarray(sizes), int(sizes.sum()), 8)
    out = TM._blocked_layout(_t(sizes), int(sizes.sum()), 8)
    assert out[-1] == ref[-1]
    for a, b in zip(out[:-1], ref[:-1]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("in_dim,num_layers,width,out_dim,sigmoid", [
    (40, 2, 64, 80, False),   # base MLP
    (47, 3, 64, 3, True),     # rgb head
    (64, 3, 64, 64, False),   # semantic head
    (32, 3, 32, 3, True),     # sky rgb head
])
def test_apply_mlp_blocks_matches_jax(in_dim, num_layers, width, out_dim, sigmoid):
    rng = np.random.RandomState(in_dim)
    num_experts, block = 3, 16
    params, layers = _layers(jax.random.PRNGKey(in_dim), in_dim, num_layers, width, out_dim,
                             num_experts)
    eids = rng.randint(0, num_experts, 70).astype(np.int32)
    routing = TR.build_padded_routing(_t(eids), num_experts, block)
    h = rng.randn(routing.to_slot.shape[0], in_dim).astype(np.float32)
    ref = jax.jit(lambda p, x, be: JM.apply_mlp_blocks(p, x, be, jax.nn.sigmoid if sigmoid
                                                       else None))(
        params, jnp.asarray(h), jnp.asarray(routing.block_expert.numpy()))
    out = TM.apply_mlp_blocks(layers, _t(h), routing.block_expert, sigmoid=sigmoid)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_apply_mlp_and_grouped_match_jax():
    rng = np.random.RandomState(7)
    params, layers = _layers(jax.random.PRNGKey(1), 8, 2, 64, 1, 0)  # shared proposal MLP
    x = rng.randn(100, 8).astype(np.float32)
    np.testing.assert_allclose(TM.apply_mlp(layers, _t(x)).numpy(),
                               np.asarray(JM.apply_mlp(params, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    params, layers = _layers(jax.random.PRNGKey(2), 16, 3, 32, 64, 4)
    sizes = np.array([30, 0, 45, 25], np.int32)
    x = rng.randn(100, 16).astype(np.float32)
    ref = jax.jit(lambda p, x, n: JM.apply_mlp_grouped(p, x, n, jax.nn.sigmoid, block=16))(
        params, jnp.asarray(x), jnp.asarray(sizes))
    out = TM.apply_mlp_grouped(layers, _t(x), _t(sizes), sigmoid=True, block=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
