"""The arithmetic of K2 and K2b (csrc/mlp_blocks.cu, csrc/mlp_blocks_bwd.cu),
emulated on the CPU and held against the JAX package in f32.

The kernels run every product on the tensor cores in 3xTF32: each f32
operand x is split into big = tf32(x) and small = tf32(x - big), rounded to
nearest with ties away from zero as ``cvt.rna.tf32.f32`` does, and
acc = a_small b_big + a_big b_small + a_big b_big is accumulated in f32
(TF32 x TF32 products are exact in f32). The emulation below does the same
in plain torch, so the claim that 3xTF32 holds K2's and K2b's tolerances is
checked here, without the card.

Tolerances: outputs atol 1e-5 + rtol 1e-4 (K2's, as chip_smoke.py); dX, dW
and db atol 1e-5 of the largest + rtol 1e-4 (K2b's). A single TF32 pass
misses them (test_single_tf32_pass_misses_the_tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presight_tpu.ops import mlp as JM
from presight_tpu_torch.ops import mlp as TM

BLOCK = 64

# (dims, sigmoid, experts): the stacks of the -tpu profile's path
STACKS = {
    "base 40-64-80": ([40, 64, 80], False, 2),
    "rgb 47-64-64-3 sigmoid": ([47, 64, 64, 3], True, 2),
    "semantic 64-64-64-64": ([64, 64, 64, 64], False, 2),
    "sky rgb 32-32-32-3 sigmoid": ([32, 32, 32, 3], True, 2),
    "sky semantic 16-32-32-64": ([16, 32, 32, 64], False, 2),
    "proposal 8-64-1": ([8, 64, 1], False, 1),
}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits) as cvt.rna: add half of the
    kept last place to the bit pattern, then clear the 13 dropped bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32: the two cross terms, then big x big, in f32."""
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass."""
    return tf32(a) @ tf32(b)


def _case(name, seed=0):
    dims, sigmoid, experts = STACKS[name]
    rng = np.random.RandomState(seed)
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        bound = 1.0 / np.sqrt(a)
        layers.append((rng.uniform(-bound, bound, (experts, a, b)).astype(np.float32),
                       rng.uniform(-bound, bound, (experts, b)).astype(np.float32)))
    block_expert = np.array([0, 0, 1, 1, 1] if experts == 2 else [0] * 5, np.int32)
    h = rng.randn(len(block_expert) * BLOCK, dims[0]).astype(np.float32)
    g = rng.randn(len(block_expert) * BLOCK, dims[-1]).astype(np.float32)
    return layers, block_expert, h, g, sigmoid


def _forward(layers, h, block_expert, sigmoid, mm):
    """K2's arithmetic on the blocked layout; returns (output, acts), acts
    being every layer's input and the last layer's pre-activation."""
    nb, idx = len(block_expert), torch.from_numpy(block_expert).long()
    acts, x = [h], h
    for i, (w, b) in enumerate(layers):
        x = (mm(x.reshape(nb, -1, x.shape[1]), w[idx]) + b[idx][:, None, :]).reshape(h.shape[0], -1)
        if i < len(layers) - 1:
            x = torch.relu(x)
        acts.append(x)
    return (torch.sigmoid(x) if sigmoid else x), acts


def _backward(layers, h, block_expert, sigmoid, grad, mm):
    """K2b's arithmetic: dPre through sigmoid' and the ReLU masks, dW =
    act^T dPre and dAct = dPre W^T as 3xTF32 products, db in f32."""
    nb, idx = len(block_expert), torch.from_numpy(block_expert).long()
    _, acts = _forward(layers, h, block_expert, sigmoid, mm)
    d = grad
    if sigmoid:
        s = torch.sigmoid(acts[-1])
        d = d * (s * (1.0 - s))
    grads = []
    for i in range(len(layers) - 1, -1, -1):
        w, b = layers[i]
        if i < len(layers) - 1:
            d = torch.where(acts[i + 1] > 0, d, torch.zeros_like(d))
        a = acts[i].reshape(nb, -1, acts[i].shape[1])
        db = d.reshape(nb, -1, d.shape[1])
        grads.insert(0, (torch.zeros_like(w).index_add_(0, idx, mm(a.transpose(1, 2), db)),
                         torch.zeros_like(b).index_add_(0, idx, db.sum(dim=1))))
        d = mm(db, w[idx].transpose(1, 2)).reshape(d.shape[0], -1)
    return d, grads


def _jax_forward(layers, h, block_expert, sigmoid):
    act = jax.nn.sigmoid if sigmoid else None
    if layers[0][0].shape[0] == 1:  # one expert: the unstacked apply_mlp
        return np.asarray(jax.jit(lambda p, x: JM.apply_mlp(p, x, act))(
            [(w[0], b[0]) for w, b in layers], h))
    return np.asarray(jax.jit(lambda p, x, be: JM.apply_mlp_blocks(p, x, be, act))(
        layers, h, block_expert))


def _t(layers):
    return [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in layers]


@pytest.mark.parametrize("name", list(STACKS))
def test_emulated_3xtf32_forward_matches_jax(name):
    layers, be, h, _, sigmoid = _case(name)
    out, _ = _forward(_t(layers), torch.from_numpy(h), be, sigmoid, mm3)
    np.testing.assert_allclose(out.numpy(), _jax_forward(layers, h, be, sigmoid),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", list(STACKS))
def test_emulated_3xtf32_backward_matches_jax(name):
    layers, be, h, g, sigmoid = _case(name, seed=1)
    act = jax.nn.sigmoid if sigmoid else None

    def loss(h, layers):
        return jnp.sum(JM.apply_mlp_blocks(layers, h, jnp.asarray(be), act) * g)

    ref_h, ref_layers = jax.jit(jax.grad(loss, argnums=(0, 1)))(h, layers)
    dx, grads = _backward(_t(layers), torch.from_numpy(h), be, sigmoid, torch.from_numpy(g), mm3)
    pairs = [(dx, ref_h)] + [p for (dw, db), (rw, rb) in zip(grads, ref_layers)
                             for p in ((dw, rw), (db, rb))]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_single_tf32_pass_misses_the_tolerance():
    """Why three products: one TF32 pass of the base MLP is off by far more
    than K2's tolerance, 3xTF32 within it."""
    layers, be, h, _, sigmoid = _case("base 40-64-80")
    ref = _jax_forward(layers, h, be, sigmoid)
    for mm, within in ((mm1, False), (mm3, True)):
        out = _forward(_t(layers), torch.from_numpy(h), be, sigmoid, mm)[0].numpy()
        assert bool(np.all(np.abs(out - ref) <= 1e-5 + 1e-4 * np.abs(ref))) == within


def test_tf32_rounding_is_round_to_nearest_ties_away():
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12, 1 + 3 * 2.0 ** -11,
                      0.0, -2.5, 3.0e-30], dtype=torch.float32)
    want = torch.tensor([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 1 + 2 * 2.0 ** -10,
                         0.0, -2.5, float(tf32(torch.tensor([3.0e-30]))[0])])
    assert torch.equal(tf32(x), want)
    v = torch.from_numpy(np.random.RandomState(2).randn(10000).astype(np.float32))
    big, small = split(v)
    assert torch.equal(tf32(big), big) and torch.equal(tf32(small), small)
    assert float(((big + small - v).abs() / v.abs()).max()) <= 2.0 ** -22


@pytest.mark.parametrize("name", ["rgb 47-64-64-3 sigmoid", "semantic 64-64-64-64"])
def test_plain_backward_on_its_own_masks_is_unchanged(name):
    layers, be, h, g, sigmoid = _case(name, seed=3)
    layers, h, g = _t(layers), torch.from_numpy(h), torch.from_numpy(g)
    be = torch.from_numpy(be)
    x, masks = h, []
    for w, b in layers[:-1]:
        x = TM.apply_mlp_blocks_plain([(w, b)], x, be)
        masks.append(x > 0)
        x = torch.relu(x)
    dx, grads = TM.mlp_blocks_bwd_plain(layers, h, be, sigmoid, g)
    mdx, mgrads = TM.mlp_blocks_bwd_plain(layers, h, be, sigmoid, g, relu_masks=masks)
    assert torch.equal(dx, mdx)
    for (dw, db), (mw, mb) in zip(grads, mgrads):
        assert torch.equal(dw, mw) and torch.equal(db, mb)


@pytest.mark.parametrize("n,rows_per_group,want", [
    (1_581_056, 512, 512),  # a render chunk's main field
    (100_352, 512, 256),
    (57_344, 512, 128),     # a training microbatch's main field
    (9_216, 512, 64),       # the sky heads of a microbatch
    (1_581_056, 128, 128),  # never across an expert block
    (32_768, 0, 64),        # the shared proposal MLP, one expert
    (262_144, 0, 512),
])
def test_rows_per_cta_choice(n, rows_per_group, want):
    assert TM.choose_rows_per_cta(n, rows_per_group, 132) == want
