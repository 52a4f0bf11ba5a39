"""Occupancy training steps in the port (presight_tpu_torch) against the
JAX package, on the CPU (seeded numpy inputs; JAX references jitted): 3
training steps of the port (scripts.train_occ.train_step) against a JAX
step written as presight_tpu/scripts/train_occ.py:279-299 writes it
(``[0]`` of the outputs, for stereo), from the same flax init through
occ_state_from_flax: the toy CLI model in float32, and a tiny resnet +
lssfpn3d + stereo + temporal + voxel-prior model (every BatchNorm site
trains) in float64 on both sides. In float32 that model is too
ill-conditioned to compare tightly: train-mode BatchNorm over the 12
values a channel of ResNet's last stage holds here turns float32 rounding
into gradients ~5% apart (the input gradient of the trunk alone reaches
~4e3), while in float64 the two agree to ~1e-14 in the loss. Checked: the
per-step loss, the step-1 gradients after clipping (the toy model's
global norm stays under 5, the resnet model's is clipped), the parameters
after 3 steps (Adam's first steps turn near-zero gradients into moves of
+-lr, so in float32 a parameter may differ by 2 k lr after k steps), the
3-step update of every parameter whose step-1 gradient is well resolved
(within 0.05 lr: the check that sees the optimizer in float32), the
BatchNorm statistics against flax's mutable result, and the EMA. The JAX
step keeps flax's updated statistics where the JAX CLI discards them (its
AdamW would decay them): the port's fix. BatchNorm, occ_loss, the EMA and
S1b's plain version alone are in test_torch_occ_train_ops.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from presight_tpu.occupancy import BEVDetOcc as JaxBEVDetOcc
from presight_tpu.occupancy import occ_loss as jax_occ_loss
from presight_tpu.utils.ema import ema_init as jax_ema_init
from presight_tpu.utils.ema import ema_update as jax_ema_update
from presight_tpu_torch import bridge
from presight_tpu_torch.occupancy import BEVDetOcc, BEVDetOccConfig
from presight_tpu_torch.scripts import train_occ as port_cli
from presight_tpu_torch.utils.ema import ema_init
from test_torch_occ_model import RESNET, _inputs

LR, WD, CLIP, DECAY, STEPS = 1e-4, 1e-2, 5.0, 0.999, 3


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


# --- 3 training steps against the JAX step ---------------------------------

TOY = dict(grid_config=port_cli.GRID, input_size=port_cli.INPUT_SIZE, downsample=16,
           view_out_channels=16, img_widths=(8, 16, 16, 32), neck_channels=32,
           bev_widths=(16, 32), bev_out_channels=16, occ_out_dim=16, num_classes=18)


def _batches(name):
    if name == "toy":
        return TOY, [port_cli.toy_batch(i) for i in range(STEPS)], np.float32
    imgs, geo, priors, _ = _inputs(RESNET)
    # distinct prior voxels, as the voxelizer gives them (a repeated voxel's
    # scatter-set has no defined winner in either framework)
    pc = priors["prior_coords"]
    res = tuple(int(r) for r in pc.max(axis=(0, 1)) + 1)
    flat = np.random.RandomState(9).choice(int(np.prod(res)), pc.shape[1], replace=False)
    priors["prior_coords"] = np.stack(np.unravel_index(flat, res), -1)[None].astype(np.int32)
    gx, gy, gz = BEVDetOccConfig(**RESNET).grid_size()
    rng = np.random.RandomState(5)
    batches = []
    for i in range(STEPS):
        b = dict(zip(port_cli._MODEL_INPUTS, [imgs[i % 2], *geo]), **priors)
        b["voxel_semantics"] = rng.randint(0, 18, (1, gx, gy, gz))
        b["mask_camera"] = (rng.rand(1, gx, gy, gz) > 0.3).astype(np.uint8)
        batches.append({k: v.astype(np.float64) if v.dtype == np.float32 else v
                        for k, v in b.items()})
    return RESNET, batches, np.float64


def _jax_step(jm, tx):
    """presight_tpu/scripts/train_occ.py:279-299, with ``[0]`` of the
    outputs (three with stereo), flax's updated statistics kept, and the
    clipped gradients returned for the check."""
    @jax.jit
    def step(variables, opt_state, ema, batch):
        def loss_fn(v):
            prior_kwargs = {k: batch[k] for k in port_cli._PRIOR_INPUTS if k in batch}
            outputs, mut = jm.apply(
                v, batch["imgs"], batch["sensor2ego"], batch["cam2imgs"], batch["post_rots"],
                batch["post_trans"], batch["bda"], train=True, mutable=["batch_stats"],
                **prior_kwargs)
            return jax_occ_loss(outputs[0], batch["voxel_semantics"],
                                batch.get("mask_camera")), mut

        (loss, mut), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables)
        clipped, _ = optax.clip_by_global_norm(CLIP).update(grads, optax.EmptyState())
        updates, opt_state = tx.update(grads, opt_state, variables)
        variables = optax.apply_updates(variables, updates)
        variables = {"params": variables["params"], "batch_stats": mut["batch_stats"]}
        ema = jax_ema_update(ema, variables, DECAY)
        return variables, opt_state, ema, loss, clipped

    return step


@pytest.fixture(scope="module", params=["toy", "resnet"])
def steps(request):
    kw, batches, dtype = _batches(request.param)
    with jax.enable_x64(dtype == np.float64):
        jm = JaxBEVDetOcc(**kw)
        b0 = batches[0]
        prior_kwargs = {k: b0[k] for k in port_cli._PRIOR_INPUTS if k in b0}
        variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                     *[b0[k] for k in port_cli._MODEL_INPUTS], **prior_kwargs)
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), variables)
        tx = optax.chain(optax.clip_by_global_norm(CLIP), optax.adamw(LR, weight_decay=WD))
        step = _jax_step(jm, tx)
        jv, js, je = variables, tx.init(variables), jax_ema_init(variables)
        jax_losses, jax_stats = [], []
        for i, b in enumerate(batches):
            jv, js, je, loss, clipped = step(jv, js, je, {k: jnp.asarray(v) for k, v in b.items()})
            jax_losses.append(float(loss))
            jax_stats.append(jax.tree_util.tree_map(np.asarray, jv["batch_stats"]))
            if i == 0:
                jax_grads = jax.tree_util.tree_map(np.asarray, clipped["params"])
        jv = jax.tree_util.tree_map(np.asarray, jv)
        je = jax.tree_util.tree_map(np.asarray, je.params)

    model = BEVDetOcc(BEVDetOccConfig(**kw), device="cpu",
                      with_prior_fusion="prior_feats" in batches[0])
    bridge.occ_state_from_flax(variables, model)
    model.to(torch.float64 if dtype == np.float64 else torch.float32)
    optimizer = port_cli.make_optimizer(model, LR, WD)
    ema = ema_init(model)
    port_losses, port_stats = [], []
    for i, b in enumerate(batches):
        loss, ema = port_cli.train_step(model, optimizer, ema, port_cli.to_device(b, "cpu"),
                                        CLIP, DECAY)
        port_losses.append(float(loss))
        port_stats.append(bridge.occ_state_to_flax(model)["batch_stats"])
        if i == 0:
            grads = {n: p.grad for n, p in model.named_parameters()}
            port_grads = bridge.occ_state_to_flax(model, grads)["params"]
    return dict(name=request.param, dtype=dtype, init_vars=variables,
                jax_losses=jax_losses, port_losses=port_losses,
                jax_grads=jax_grads, port_grads=port_grads, jax_stats=jax_stats,
                port_stats=port_stats, jax_vars=jv, port_vars=bridge.occ_state_to_flax(model),
                jax_ema=je, port_ema=bridge.occ_state_to_flax(model, ema.params),
                ema_updates=ema.updates)


def test_step_losses_match_jax(steps):
    """float32: the toy model's losses within 1e-5 after Adam's +-lr moves;
    float64: within 1e-10."""
    atol = 1e-5 if steps["dtype"] == np.float32 else 1e-10
    np.testing.assert_allclose(steps["port_losses"], steps["jax_losses"], rtol=0, atol=atol)
    assert steps["port_losses"][-1] < steps["port_losses"][0]


def _before_batchnorm(path, modules) -> bool:
    """A conv bias that a train-mode BatchNorm follows (``Conv_i`` beside
    ``BatchNorm_i`` in these models; ``modules`` maps a parent path to its
    submodules' names): its gradient is 0 in exact arithmetic, rounding
    noise in each framework."""
    return (path[-1] == "bias" and path[-2].startswith("Conv_")
            and path[-2].replace("Conv_", "BatchNorm_") in modules.get(path[:-2], ()))


def test_step_one_gradients_match_jax(steps):
    """Every leaf of the clipped step-1 gradients: float32, within 1e-4 of
    the leaf's largest plus 1e-6 of the largest of all; float64 (compared
    through float32 trees), 1e-6 of the leaf's largest plus 1e-9. A conv
    bias before a train-mode BatchNorm (exactly 0) must be noise in both:
    under 1e-4 of the largest gradient in float32, 1e-9 in float64."""
    modules = {}
    for path, _ in _leaves(steps["jax_grads"]):
        modules.setdefault(path[:-2], set()).add(path[-2])
    want_all = max(float(np.abs(g).max()) for _, g in _leaves(steps["jax_grads"]))
    f32 = steps["dtype"] == np.float32
    paths = zeros = 0
    for path, want in _leaves(steps["jax_grads"]):
        got = _at(steps["port_grads"], path)
        if _before_batchnorm(path, modules):
            bound = 1e-4 * want_all if f32 else 1e-9
            assert np.abs(got).max() <= bound and np.abs(want).max() <= bound, path
            zeros += 1
        else:
            atol = (1e-4 * float(np.abs(want).max()) + 1e-6 * want_all if f32
                    else 1e-6 * float(np.abs(want).max()) + 1e-9)
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg="/".join(path))
        paths += 1
    assert zeros > 0 and paths == sum(1 for _ in _leaves(steps["port_grads"]))


def test_parameters_after_three_steps_match_jax(steps):
    """float32: within 2 k lr (Adam's sign of a near-zero gradient);
    float64: 1e-6 (the float32 trees). In float32 that bound would pass a
    no-op optimizer (Adam moves a parameter about lr a step):
    test_updates_of_resolved_gradients_match_jax holds the update itself."""
    atol = 2 * STEPS * LR if steps["dtype"] == np.float32 else 1e-6
    for path, want in _leaves(steps["jax_vars"]["params"]):
        np.testing.assert_allclose(_at(steps["port_vars"]["params"], path), want, rtol=0,
                                   atol=atol, err_msg="/".join(path))


def test_updates_of_resolved_gradients_match_jax(steps):
    """The 3-step update (parameters after, less the init both start from)
    of every parameter whose step-1 gradient is well resolved (above 1e-2
    of its leaf's largest plus 1e-4 of the largest of all, 100 times the
    float32 gradient tolerance) within 0.05 lr of JAX's (measured: 0.0024
    lr for the toy model in float32, 0.0006 lr for the resnet model through
    float32 trees). Adam turns such a gradient into a move of about lr a
    step, so the median JAX update there is at least lr / 2 and a no-op or
    wrong optimizer fails."""
    want_all = max(float(np.abs(g).max()) for _, g in _leaves(steps["jax_grads"]))
    moves = []
    for path, g1 in _leaves(steps["jax_grads"]):
        resolved = np.abs(g1) > 1e-2 * float(np.abs(g1).max()) + 1e-4 * want_all
        if not resolved.any():
            continue
        init = _at(steps["init_vars"]["params"], path)
        want = (_at(steps["jax_vars"]["params"], path) - init)[resolved]
        got = (_at(steps["port_vars"]["params"], path) - init)[resolved]
        np.testing.assert_allclose(got, want, rtol=0, atol=0.05 * LR, err_msg="/".join(path))
        moves.append(np.abs(want))
    assert np.median(np.concatenate(moves)) >= LR / 2


def test_batch_stats_follow_flax_mutable_result(steps):
    """The running statistics after each step against flax's mutable
    result: float64, 1e-6 (the float32 trees); float32, 1e-6 + 1e-5
    relative after step 1, and after step k > 1 the weights may be 2 (k - 1)
    lr apart (a conv bias before a BatchNorm takes Adam's +-lr from a noise
    gradient, shifting its channel's mean): atol 2 (k - 1) lr, rtol 1e-3."""
    f32 = steps["dtype"] == np.float32
    for i, (got, want) in enumerate(zip(steps["port_stats"], steps["jax_stats"])):
        rtol, atol = ((1e-5, 1e-6) if i == 0 else (1e-3, 2 * i * LR)) if f32 else (0.0, 1e-6)
        for path, w in _leaves(want):
            np.testing.assert_allclose(_at(got, path), w, rtol=rtol, atol=atol,
                                       err_msg=f"step {i + 1} " + "/".join(path))


def test_ema_after_three_steps_matches_jax(steps):
    """The EMA stays within a few thousandths of the last values: its
    parameters as the parameters (2 k lr in float32), its statistics as
    the last step's statistics; float64, 1e-6."""
    f32 = steps["dtype"] == np.float32
    assert steps["ema_updates"] == STEPS
    for path, want in _leaves(steps["jax_ema"]):
        stat = path[0] == "batch_stats"
        rtol, atol = ((1e-3 if stat else 0.0, 2 * STEPS * LR) if f32 else (0.0, 1e-6))
        np.testing.assert_allclose(_at(steps["port_ema"], path), want, rtol=rtol, atol=atol,
                                   err_msg="/".join(path))
