"""The parts of occupancy training in the port (presight_tpu_torch)
against the JAX package, on the CPU (seeded numpy inputs):

  * BatchNorm in train mode against flax.linen.BatchNorm for 2-D and 3-D
    inputs: the output (atol 1e-5), the input and affine gradients of one
    vjp (atol 1e-5), and the running statistics against flax's
    ``mutable=["batch_stats"]`` result (atol 1e-6);
  * occ_loss with and without a camera mask (and an empty mask) against
    the JAX occ_loss, value and logit gradient (rtol 1e-6, atol 1e-7);
  * the EMA against the JAX ema_update over 3 updates, with and without
    init_updates (rtol 1e-6, atol 1e-7: one float32 multiply-add a leaf);
  * bev_pool_v2's backward: bev_pool_v2_bwd_plain against jax.vjp of the
    JAX bev_pool_v2 and against autograd of the plain forward, through the
    autograd Function, on inputs with points outside the grid, a quarter on
    voxel faces and voxels of hundreds of points (rtol 1e-5 + atol 1e-6 of
    the largest gradient: sums over points and channels in other orders);
    the incoming gradient as a strided slice of torch.cat's backward, and
    ``coor`` without a gradient.

The training steps are in test_torch_occ_train.py.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presight_tpu.occupancy import occ_loss as jax_occ_loss
from presight_tpu.occupancy.bev_pool import bev_pool_v2 as jax_bev_pool_v2
from presight_tpu.utils.ema import ema_init as jax_ema_init
from presight_tpu.utils.ema import ema_update as jax_ema_update
from presight_tpu_torch import bridge
from presight_tpu_torch.models.layers import BatchNorm, init_weights
from presight_tpu_torch.occupancy import BEVDetOcc, BEVDetOccConfig, occ_loss
from presight_tpu_torch.occupancy import bev_pool as PB
from presight_tpu_torch.utils.ema import ema_init, ema_update
from test_torch_cuda import S1_GRID, S1_IV, S1_LB, s1_points
from test_torch_occ_model import RESNET

DECAY = 0.999


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.mark.parametrize("shape", [(2, 5, 6, 7), (1, 4, 3, 5, 6)], ids=["2d", "3d"])
def test_batchnorm_train_mode_matches_flax(shape):
    rng = np.random.RandomState(0)
    C = shape[1]
    x = (rng.randn(*shape) * 2 + 3).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    scale = (rng.rand(C) + 0.5).astype(np.float32)
    bias = rng.randn(C).astype(np.float32)
    mean0 = (rng.randn(C) * 0.1).astype(np.float32)
    var0 = (rng.rand(C) + 0.5).astype(np.float32)
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}
    bn = fnn.BatchNorm(use_running_average=False)

    def apply(xl, s, b):
        return bn.apply({"params": {"scale": s, "bias": b}, "batch_stats": stats}, xl,
                        mutable=["batch_stats"])

    xl = jnp.asarray(np.moveaxis(x, 1, -1))
    want, mut = apply(xl, jnp.asarray(scale), jnp.asarray(bias))
    _, vjp = jax.vjp(lambda *a: apply(*a)[0], xl, jnp.asarray(scale), jnp.asarray(bias))
    dx, ds, db = vjp(jnp.asarray(np.moveaxis(g, 1, -1)))

    m = BatchNorm(C, device="cpu")
    with torch.no_grad():
        for t, v in ((m.weight, scale), (m.bias, bias), (m.running_mean, mean0),
                     (m.running_var, var0)):
            t.copy_(torch.from_numpy(v))
    m.train()
    xt = torch.from_numpy(x).requires_grad_()
    y = m(xt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(np.moveaxis(y.detach().numpy(), 1, -1), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.moveaxis(xt.grad.numpy(), 1, -1), dx, atol=1e-5, rtol=0)
    np.testing.assert_allclose(m.weight.grad.numpy(), ds, atol=1e-5, rtol=0)
    np.testing.assert_allclose(m.bias.grad.numpy(), db, atol=1e-5, rtol=0)
    np.testing.assert_allclose(m.running_mean.numpy(), mut["batch_stats"]["mean"], atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(m.running_var.numpy(), mut["batch_stats"]["var"], atol=1e-6, rtol=0)
    # Eval mode normalises with the (now updated) running statistics.
    m.eval()
    want_eval = fnn.BatchNorm(use_running_average=True).apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": m.running_mean.numpy(), "var": m.running_var.numpy()}}, xl)
    with torch.no_grad():
        np.testing.assert_allclose(np.moveaxis(m(torch.from_numpy(x)).numpy(), 1, -1),
                                   want_eval, atol=1e-5, rtol=0)


@pytest.mark.parametrize("mask", ["none", "mask", "empty_mask"])
def test_occ_loss_matches_jax(mask):
    rng = np.random.RandomState(1)
    logits = (rng.randn(2, 5, 4, 3, 18) * 3).astype(np.float32)
    labels = rng.randint(0, 18, (2, 5, 4, 3))
    m = {"none": None, "mask": (rng.rand(2, 5, 4, 3) > 0.4).astype(np.uint8),
         "empty_mask": np.zeros((2, 5, 4, 3), np.uint8)}[mask]
    want, dwant = jax.value_and_grad(jax_occ_loss)(
        jnp.asarray(logits), jnp.asarray(labels), None if m is None else jnp.asarray(m))
    lt = torch.from_numpy(logits).requires_grad_()
    got = occ_loss(lt, torch.from_numpy(labels), None if m is None else torch.from_numpy(m))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(lt.grad.numpy(), dwant, rtol=1e-6, atol=1e-7)
    if mask == "empty_mask":
        assert float(got) == 0.0


@pytest.mark.parametrize("init_updates", [0, 10560])
def test_ema_matches_jax(init_updates):
    """The port's EMA walks the state_dict (parameters and running
    statistics); the same values as a flax tree through the JAX EMA."""
    model = init_weights(BEVDetOcc(BEVDetOccConfig(**{
        k: v for k, v in RESNET.items() if k not in ("prior_pc_range", "prior_voxel_size")}),
        device="cpu"), torch.Generator().manual_seed(0))
    state = ema_init(model, init_updates)
    jstate = jax_ema_init(bridge.occ_state_to_flax(model), init_updates=init_updates)
    gen = torch.Generator().manual_seed(1)
    for _ in range(3):
        with torch.no_grad():
            for t in model.state_dict().values():
                t.add_(torch.randn(t.shape, generator=gen) * 0.1)
        state = ema_update(state, model, DECAY)
        jstate = jax_ema_update(jstate, bridge.occ_state_to_flax(model), DECAY)
    assert state.updates == int(jstate.updates) == init_updates + 3
    got = bridge.occ_state_to_flax(model, state.params)
    for path, want in _leaves(jax.tree_util.tree_map(np.asarray, jstate.params)):
        np.testing.assert_allclose(_at(got, path), want, rtol=1e-6, atol=1e-7,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("kind,B,N,D,H,W,C", [("random", 2, 3, 7, 5, 6, 32),
                                              ("heavy", 2, 3, 10, 8, 10, 40)])
def test_bev_pool_backward_matches_jax_vjp_and_autograd(kind, B, N, D, H, W, C):
    rng = np.random.RandomState(2)
    depth, feat, coor = s1_points(rng, kind, B, N, D, H, W, C)
    gx, gy, gz = S1_GRID
    g = rng.randn(B, C, gz, gy, gx).astype(np.float32)
    _, vjp = jax.vjp(lambda d, f: jax_bev_pool_v2(d, f, jnp.asarray(coor), S1_LB, S1_IV, S1_GRID),
                     jnp.asarray(depth), jnp.asarray(feat))
    want_depth, want_feat = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    T = torch.from_numpy
    got_depth, got_feat = PB.bev_pool_v2_bwd_plain(T(depth), T(feat), T(coor), T(g), S1_LB,
                                                   S1_IV, S1_GRID)

    def close(got, want):
        atol = 1e-6 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)

    close(got_depth.numpy(), want_depth)
    close(got_feat.numpy(), want_feat)
    ranks = PB.voxel_ranks(T(coor), S1_LB, S1_IV, S1_GRID)
    outside = (ranks == B * gx * gy * gz).numpy()
    assert outside.any() and (~outside).any()
    assert np.all(got_depth.numpy()[outside] == 0)

    # Through the autograd Function, the incoming gradient a strided slice
    # of torch.cat's backward; and autograd of the plain forward.
    d1, f1, c1 = (T(a).requires_grad_() for a in (depth, feat, coor))
    out = PB.bev_pool_v2(d1, f1, c1, S1_LB, S1_IV, S1_GRID)
    assert out.grad_fn is not None
    both = torch.cat([out, torch.zeros_like(out)], dim=1)
    (both * torch.cat([T(g), T(g)], dim=1)).sum().backward()
    assert c1.grad is None
    np.testing.assert_array_equal(d1.grad.numpy(), got_depth.numpy())
    np.testing.assert_array_equal(f1.grad.numpy(), got_feat.numpy())
    d2, f2 = (T(a).requires_grad_() for a in (depth, feat))
    PB.bev_pool_v2_plain(d2, f2, T(coor), S1_LB, S1_IV, S1_GRID).backward(T(g))
    close(d2.grad.numpy(), want_depth)
    close(f2.grad.numpy(), want_feat)
