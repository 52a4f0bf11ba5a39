"""The backward passes of the port's kernel Functions, through their plain
versions on the CPU, against jax.grad of the JAX function and against torch
autograd of the port's plain forward:

  * hash encoding (K1b + sort + K5): table gradients, all three storages,
    with and without experts, and their accumulation into the tables'
    .grad over two backward calls;
  * the grouped MLP (K2b): dX, dW and db, with and without the sigmoid
    epilogue, stacked experts on block-padded rows and one unstacked MLP;
  * volume rendering (K3b): the densities' and the payload rows' gradients
    from weights, accumulation, expected depth and composite, with
    saturated rays (accumulation exactly 1) and empty rays (exactly 0), and
    a batch whose expected depth ties the clip bound; and the element-wise
    float64 bound that chip_smoke.py holds K3b's d density to on the
    reference training path (the plain f32 version meets it, planted faults
    fail it).

Tolerances: rtol 1e-4 + atol 1e-6 of the largest gradient of the leaf: the
sums run in another order (sorted segment sums, per-expert block sums,
reverse cumsums) than XLA's transposes. JAX functions are jitted.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presight_tpu.ops import hash_encoding as JH
from presight_tpu.ops import mlp as JMLP
from presight_tpu.ops import rays as JRays
from presight_tpu_torch.configs import HashEncodingConfig
from presight_tpu_torch.ops import hash_encoding as TH
from presight_tpu_torch.ops import mlp as TMLP
from presight_tpu_torch.ops import renderers as TR
from presight_tpu_torch.ops.math import clip


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-6 * max(np.abs(want).max(), 1e-30), err_msg=err_msg)


@pytest.mark.parametrize("with_experts", [False, True], ids=["single", "experts"])
@pytest.mark.parametrize("storage", ["corner", "cell", "shared"])
def test_hash_encode_table_grad_matches_jax(storage, with_experts):
    kw = dict(num_levels=3, min_res=4, max_res=64, log2_hashmap_size=7,
              features_per_level=2, storage=storage)
    jcfg, tcfg = JH.HashEncodingConfig(**kw), HashEncodingConfig(**kw)
    rng = np.random.RandomState(3)
    num_experts = 3 if with_experts else 1
    table = jax.tree_util.tree_map(np.asarray,
                                   JH.init_hash_table(jax.random.PRNGKey(0), jcfg, num_experts))
    n = 400
    pos = rng.rand(n, 3).astype(np.float32)
    pos[:16] = rng.randint(0, 5, (16, 3)) / 4.0  # grid nodes: ceil == floor
    eids = rng.randint(0, num_experts, n).astype(np.int32) if with_experts else None
    g = rng.randn(n, tcfg.out_dim).astype(np.float32)

    def loss(t):
        out = JH.hash_encode(t, jnp.asarray(pos), jcfg,
                             None if eids is None else jnp.asarray(eids))
        return jnp.sum(out * g)

    ref = jax.jit(jax.grad(loss))(jax.tree_util.tree_map(jnp.asarray, table))

    def port(tables, fn):
        leaves = [torch.from_numpy(np.array(t)).requires_grad_() for t in
                  (tables if storage == "shared" else [tables])]
        arg = leaves if storage == "shared" else leaves[0]
        out = fn(arg, torch.from_numpy(pos), tcfg,
                 None if eids is None else torch.from_numpy(eids))
        torch.sum(out * torch.from_numpy(g)).backward()
        return [leaf.grad.numpy() for leaf in leaves]

    got = port(table, TH.hash_encode)
    autograd = port(table, TH.hash_encode_plain)
    refs = ref if storage == "shared" else [ref]
    for a, b, r in zip(got, autograd, refs):
        _close(a, r, "vs jax.grad")
        _close(a, b, "vs autograd of the plain forward")


@pytest.mark.parametrize("with_experts", [False, True], ids=["single", "experts"])
@pytest.mark.parametrize("storage", ["corner", "cell", "shared"])
def test_hash_encode_grads_accumulate_in_tables(storage, with_experts):
    """The table-gradient contract: two .backward() calls through
    hash_encode add into the tables' .grad (K5 accumulates into it; the
    first call allocates it), so it equals the sum of two jax.grads; the
    tables' hooks never run, and torch.autograd.grad finds the tables
    unused."""
    kw = dict(num_levels=3, min_res=4, max_res=64, log2_hashmap_size=7,
              features_per_level=2, storage=storage)
    jcfg, tcfg = JH.HashEncodingConfig(**kw), HashEncodingConfig(**kw)
    rng = np.random.RandomState(8)
    num_experts = 3 if with_experts else 1
    table = jax.tree_util.tree_map(np.asarray,
                                   JH.init_hash_table(jax.random.PRNGKey(1), jcfg, num_experts))
    n = 300
    pos = [rng.rand(n, 3).astype(np.float32) for _ in range(2)]
    eids = [rng.randint(0, num_experts, n).astype(np.int32) if with_experts else None
            for _ in range(2)]
    gs = [rng.randn(n, tcfg.out_dim).astype(np.float32) for _ in range(2)]

    def jax_grad(p, e, g):
        def loss(t):
            out = JH.hash_encode(t, jnp.asarray(p), jcfg, None if e is None else jnp.asarray(e))
            return jnp.sum(out * g)
        return jax.jit(jax.grad(loss))(jax.tree_util.tree_map(jnp.asarray, table))

    refs = [jax_grad(p, e, g) for p, e, g in zip(pos, eids, gs)]
    refs = [refs[0], refs[1]] if storage == "shared" else [[refs[0]], [refs[1]]]
    leaves = [torch.from_numpy(np.array(t)).requires_grad_() for t in
              (table if storage == "shared" else [table])]
    fired = []
    for leaf in leaves:
        leaf.register_hook(lambda g: fired.append(g))
        leaf.register_post_accumulate_grad_hook(lambda t: fired.append(t))
    arg = leaves if storage == "shared" else leaves[0]

    def out(i):
        return TH.hash_encode(arg, torch.from_numpy(pos[i]), tcfg,
                              None if eids[i] is None else torch.from_numpy(eids[i]))

    for i in range(2):
        torch.sum(out(i) * torch.from_numpy(gs[i])).backward()
    assert not fired
    for leaf, r0, r1 in zip(leaves, refs[0], refs[1]):
        _close(leaf.grad.numpy(), np.asarray(r0) + np.asarray(r1), "two backwards vs two jax.grads")
    with pytest.raises(RuntimeError, match="not have been used"):
        torch.autograd.grad(torch.sum(out(0)), leaves)


def _blocked(rng, group_sizes, block):
    n = int(sum(group_sizes))
    _, src, valid, block_expert, _ = TMLP._blocked_layout(torch.tensor(group_sizes), n, block)
    return src, valid, block_expert


@pytest.mark.parametrize("sigmoid", [False, True], ids=["linear", "sigmoid"])
def test_mlp_blocks_grads_match_jax(sigmoid):
    rng = np.random.RandomState(4)
    E, block, dims = 3, 64, [7, 16, 16, 5]
    src, valid, be = _blocked(rng, [70, 0, 150], block)
    n_pad = src.shape[0]
    h = (rng.randn(n_pad, dims[0]) * valid.numpy()[:, None]).astype(np.float32)
    layers = [(rng.randn(E, a, b).astype(np.float32) * 0.5, rng.randn(E, b).astype(np.float32) * 0.1)
              for a, b in zip(dims[:-1], dims[1:])]
    g = rng.randn(n_pad, dims[-1]).astype(np.float32)
    act = jax.nn.sigmoid if sigmoid else None

    def loss(h, layers):
        return jnp.sum(JMLP.apply_mlp_blocks(layers, h, jnp.asarray(be.numpy()), act) * g)

    ref_h, ref_layers = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(h), jax.tree_util.tree_map(jnp.asarray, layers))

    def port(fn):
        th = torch.from_numpy(h).requires_grad_()
        tl = [(torch.from_numpy(w).requires_grad_(), torch.from_numpy(b).requires_grad_())
              for w, b in layers]
        torch.sum(fn(tl, th, be, sigmoid) * torch.from_numpy(g)).backward()
        return th.grad.numpy(), [(w.grad.numpy(), b.grad.numpy()) for w, b in tl]

    for name, fn in (("kernel Function", TMLP.apply_mlp_blocks),
                     ("autograd of the plain forward", TMLP.apply_mlp_blocks_plain)):
        dh, dl = port(fn)
        _close(dh, ref_h, f"dX, {name}")
        for i, ((dw, db), (rw, rb)) in enumerate(zip(dl, ref_layers)):
            _close(dw, rw, f"dW[{i}], {name}")
            _close(db, rb, f"db[{i}], {name}")


def test_unstacked_mlp_grads_match_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(90, 8).astype(np.float32)
    layers = [(rng.randn(8, 12).astype(np.float32), rng.randn(12).astype(np.float32)),
              (rng.randn(12, 1).astype(np.float32), rng.randn(1).astype(np.float32))]
    g = rng.randn(90, 1).astype(np.float32)
    ref_x, ref_l = jax.jit(jax.grad(lambda x, l: jnp.sum(JMLP.apply_mlp(l, x) * g),
                                    argnums=(0, 1)))(jnp.asarray(x),
                                                     jax.tree_util.tree_map(jnp.asarray, layers))
    tx = torch.from_numpy(x).requires_grad_()
    tl = [(torch.from_numpy(w).requires_grad_(), torch.from_numpy(b).requires_grad_())
          for w, b in layers]
    torch.sum(TMLP.apply_mlp(tl, tx) * torch.from_numpy(g)).backward()
    _close(tx.grad.numpy(), ref_x, "dX")
    for (w, b), (rw, rb) in zip(tl, ref_l):
        _close(w.grad.numpy(), rw, "dW")
        _close(b.grad.numpy(), rb, "db")


def _jax_render(deltas, density, steps, payload, slot_of_sample, num_rays):
    """The JAX model's render: get_weights, accumulation, the clipped
    expected depth and the segment-sum composite of padded payload rows."""
    weights = JRays.get_weights(deltas, density)
    acc = jnp.sum(weights, -1)
    expected = jnp.sum(weights * steps, -1) / (acc + 1e-10)
    expected = jnp.clip(expected, jnp.min(steps), jnp.max(steps))
    rows = payload[slot_of_sample]
    composite = jnp.sum(rows.reshape(num_rays, deltas.shape[1], -1) * weights[..., None], 1)
    return weights, jnp.clip(acc, 0.0, 1.0), expected, composite


# case: (rays, samples per ray, payload width, largest delta, ray 0's
# saturated sample or None)
RENDER_CASES = {"render": (40, 12, 5, 0.2, 2), "depth_tie": (40, 12, 5, 0.2, 2),
                "long_ray": (2, 1024, 67, 0.002, None)}


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_volume_render_grads_match_jax(case):
    """long_ray: one ray of a length whose payload rows the card's kernels
    read from device memory (S x C past shared memory) beside an empty
    one."""
    rng = np.random.RandomState(6)
    Rn, S, C, max_delta, sat = RENDER_CASES[case]
    deltas = (rng.rand(Rn, S) * max_delta).astype(np.float32)
    density = (np.exp(rng.randn(Rn, S)) * 3.0).astype(np.float32)
    if sat is not None:
        density[0, sat] = 1e30  # saturated: the accumulation is exactly 1.0
    density[1, :] = 0.0  # empty: exactly 0.0
    steps = np.cumsum(deltas, -1).astype(np.float32) + 0.01
    if case == "depth_tie":
        # Every ray's weight on one step: the expected depth equals it, and
        # ray 3's step is the batch's largest, where the clip ties.
        density[:] = 0.0
        density[[0] + list(range(2, Rn)), 4] = 1e30
        steps[3, 4] = steps.max() + 1.0
    P = Rn * S + 64
    payload = rng.rand(P, C).astype(np.float32)
    slots = rng.permutation(P)[:Rn * S].astype(np.int32)
    gw, gacc, gexp, gcomp = (rng.randn(Rn, S).astype(np.float32), rng.randn(Rn).astype(np.float32),
                             rng.randn(Rn).astype(np.float32), rng.randn(Rn, C).astype(np.float32))

    def loss(density, payload):
        w, acc, e, comp = _jax_render(jnp.asarray(deltas), density, jnp.asarray(steps), payload,
                                      jnp.asarray(slots), Rn)
        return jnp.sum(w * gw) + jnp.sum(acc * gacc) + jnp.sum(e * gexp) + jnp.sum(comp * gcomp)

    ref_d, ref_p = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(density),
                                                            jnp.asarray(payload))

    def port(fn):
        td = torch.from_numpy(density).requires_grad_()
        tp = torch.from_numpy(payload).requires_grad_()
        out = fn(torch.from_numpy(deltas), td, torch.from_numpy(steps), tp,
                 torch.from_numpy(slots))
        total = (torch.sum(out["weights"] * torch.from_numpy(gw))
                 + torch.sum(clip(out["accumulation"], 0.0, 1.0) * torch.from_numpy(gacc))
                 + torch.sum(out["expected_depth"] * torch.from_numpy(gexp))
                 + torch.sum(out["composite"] * torch.from_numpy(gcomp)))
        total.backward()
        return td.grad.numpy(), tp.grad.numpy(), out

    got_d, got_p, out = port(TR.volume_render)
    auto_d, auto_p, _ = port(TR.volume_render_plain)
    acc = out["accumulation"].detach().numpy()
    assert (sat is None or acc[0] == 1.0) and acc[1] == 0.0
    if case == "depth_tie":
        assert out["expected_depth"][3] == float(steps.max())
    _close(got_d, ref_d, "d density vs jax.grad")
    _close(got_p, ref_p, "d payload vs jax.grad")
    _close(got_d, auto_d, "d density vs autograd of the plain forward")
    _close(got_p, auto_p, "d payload vs autograd of the plain forward")


def test_k3b_density_bound_admits_f32_and_rejects_planted_faults():
    """chip_smoke.py's check of K3b's d density against the float64 formula
    (k3b_density_bound), run here with the plain f32 version as the kernel:
    on rays that saturate gradually under a large dL/dacc (the two sums
    cancel) beside ordinary and empty rays, the f32 evaluation meets the
    bound, which lies under |d density| on most elements, while d density x
    0.9, zeros and values moved one sample each fail it."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)

    gen = torch.Generator().manual_seed(3)
    R, S, C = 64, 64, 67
    deltas = torch.rand((R, S), generator=gen) * 0.05
    dens = torch.exp(torch.randn((R, S), generator=gen) * 2.0) * 4.0
    dens[:16] *= 200.0
    dens[16:20] = 0.0
    steps = torch.cumsum(deltas, -1) + 0.005
    payload = torch.rand((R * S + 64, C), generator=gen)
    index = torch.randperm(R * S + 64, generator=gen)[:R * S].int()
    fwd = TR.volume_render_plain(deltas, dens, steps, payload, index)
    assert bool((fwd["accumulation"][:16] == 1.0).all())
    g_acc = torch.randn(R, generator=gen)
    g_acc[:16] = 50.0
    args = (deltas, dens, steps, payload, index, fwd["weights"],
            torch.randn((R, S), generator=gen) * 1e-3, g_acc, torch.randn(R, generator=gen),
            torch.randn((R, C), generator=gen) * 1e-2)
    exact, tol = CS.k3b_density_bound(*args)
    assert int((tol < exact.abs()).sum()) > exact.numel() // 2
    plain = TR.volume_render_bwd_plain(*args)[0]
    chk = CS.Checker()
    CS.check_k3b_density(chk, "f32", args, plain)
    assert chk.failures == []
    chk = CS.Checker()
    CS.check_k3b_density(chk, "x 0.9", args, plain * 0.9)
    assert chk.failures == ["volume_render_bwd d density x 0.9: kernel fails the float64 check"]
