"""The port's training slice against the JAX package: one whole training
step (presight_tpu_torch.engine.train_step against
presight_tpu.engine.train_step.make_train_step(split_update=True)) at one and
at two microbatches, the trainer's batch order against the JAX DataManager,
the Adam schedule, the trainer config, and a short training run whose loss
falls.

The step runs the tiny -tpu-shaped config of test_torch_slice.py (lidar
depth loss on, so the expected-depth and line-of-sight gradients flow too),
and that config made reference-exact (REFERENCE: 'corner' storage,
per-expert proposal MLPs, a hash-field first round, no grid), on the same
weights (drawn by the port, carried to JAX by the bridge), the
same cached grid, the same batch and JAX's own random draws, which the test
makes as JAX's step makes them (one key per microbatch, one split per
sampling round) and hands to the port.

Tolerances, and why (measured on this fixture: losses 2.6e-6 relative,
gradients 2.5e-5 of the leaf's largest, parameters 3.7e-9):
  * losses and psnr: rtol 2e-5 (sums of a few hundred terms per loss, in
    another order);
  * gradients, leaf by leaf: atol 1e-4 of the leaf's largest gradient: the
    table gradients are sorted segment sums against XLA's scatter-add,
    the MLP weight gradients per-expert block sums against XLA's einsum
    transposes, and autograd adds the two microbatches' gradients in
    another order than the JAX scan;
  * parameters after one Adam step: rtol 1e-6 + atol 1e-7, compared where
    the gradient is zero in both or above 1e-3 of the leaf's largest
    (with eps = 1e-15 the first update is lr * sign(g + wd p), so an element
    whose gradient is rounding noise may step either way).
The JAX package labels the proposal fields' aabb and centroid buffers as
'proposal_networks', so its weight decay moves them; the port freezes every
buffer. Those two leaves are checked for exactly that.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from presight_tpu.data.cameras import CameraParams as JCameraParams
from presight_tpu.engine import optimizers as JOpt
from presight_tpu.engine import train_step as JTS
from presight_tpu.models import nerfacto_ms as JM
from presight_tpu_torch import bridge, configs as TCfg
from presight_tpu_torch.data.cameras import CameraParams
from presight_tpu_torch.data.device_store import DeviceRayStore
from presight_tpu_torch.engine import optimizers as TOpt
from presight_tpu_torch.engine.train_step import StepScalars, train_step
from presight_tpu_torch.data.datamanager import DataManager as TDataManager
from presight_tpu_torch.data.dataset import PixelChunk as TPixelChunk
from presight_tpu_torch.engine.trainer import Trainer
from presight_tpu_torch.models import nerfacto_ms as TM
from test_torch_slice import TINY

R = 32
OPT = dict(lr=1e-2, max_steps=100, warmup_steps=10, milestones=(25, 50, 75))
PROFILES = {"tpu": TINY,
            "reference": dict(TINY, hash_storage="corner", prop_shared_mlp=False, prop_grid_res=0)}


def _setup(kw=TINY):
    rng = np.random.RandomState(0)
    cent = (rng.randn(2, 3) * 0.5).astype(np.float32)
    aabbs = np.stack([np.stack([c - 1.5, c + 1.5]) for c in cent]).astype(np.float32)
    jcfg, tcfg = JM.NerfactoNuscMSConfig(**kw), TCfg.NerfactoNuscMSConfig(**kw)
    init = TM.init_model(torch.Generator().manual_seed(0), tcfg, aabbs, cent, 6, 2, device="cpu")
    params_np = bridge.to_numpy(init.params())
    for tree in (params_np["field"], *params_np["props"]):
        t = tree["hash_table"]
        tree["hash_table"] = [x * 3e3 for x in t] if isinstance(t, list) else t * 3e3
    n = 3
    c2w = np.tile(np.eye(3, 4, dtype=np.float32)[None], (n, 1, 1))
    c2w[:, :3, 3] = (rng.randn(n, 3) * 0.3).astype(np.float32)
    cams = dict(c2w=c2w, fx=np.full(n, 8.0, np.float32), fy=np.full(n, 8.0, np.float32),
                cx=np.full(n, 10.0, np.float32), cy=np.full(n, 3.0, np.float32),
                video_ids=np.array([0, 1, 1], np.int32))
    batch = dict(
        ray_index=np.stack([rng.randint(0, n, R), rng.randint(0, 6, R),
                            rng.randint(0, 20, R)], -1).astype(np.int32),
        rgb=rng.rand(R, 3).astype(np.float32),
        sky=(rng.rand(R) < 0.25).astype(np.float32),
        depth=(rng.rand(R) * 60.0).astype(np.float32),
        features=(rng.rand(R, 64) * 1.4 - 0.2).astype(np.float32))
    return jcfg, tcfg, params_np, cams, batch


def _capture_grads():
    """An optax transform that applies no update and keeps the gradients as
    its state, so the JAX step's gradients can be read exactly."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(lambda p: zeros(p), lambda g, s, p=None: (zeros(g), g))


def _jax_draws(key, k, micro, rounds):
    """The uniforms JAX's step draws: per microbatch key (the step key when
    k == 1, else split(key, k)), one split per sampling round."""
    keys = [key] if k == 1 else list(jax.random.split(key, k))
    out = []
    for mk in keys:
        draws = []
        for _ in range(rounds):
            mk, sub = jax.random.split(mk)
            draws.append(torch.from_numpy(np.array(
                jax.random.uniform(sub, (micro, 1), jnp.float32))))
        out.append(draws)
    return out


@pytest.mark.parametrize("k,profile", [(1, "tpu"), (2, "tpu"), (1, "reference")],
                         ids=["1", "2", "reference"])
def test_train_step_matches_jax(k, profile):
    jcfg, tcfg, params_np, cams, batch = _setup(PROFILES[profile])
    micro = R // k
    scal = (np.float32(0.5), np.float32(3.0), np.float32(0.05))
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    jgrid = jax.jit(lambda p: JM.make_prop_grid(p, jcfg))(jparams)
    groups = {name: JOpt.OptimizerGroupConfig(**OPT) for name in ("proposal_networks", "fields")}
    step = JTS.make_train_step(jcfg, _capture_grads(), stop_prop_grad=False, donate=False,
                               split_update=True, microbatch_rays=micro)
    key = jax.random.PRNGKey(7)
    state, ref = step(JTS.init_train_state(jparams, _capture_grads()),
                      JCameraParams(**{k_: jnp.asarray(v) for k_, v in cams.items()}),
                      {k_: jnp.asarray(v) for k_, v in batch.items()}, key,
                      JTS.StepScalars(*(jnp.asarray(s) for s in scal)), jgrid)
    ref_grads = state.opt_state
    tx = JOpt.make_optimizer(groups, JM.param_groups(jparams))
    updates, _ = jax.jit(tx.update)(ref_grads, tx.init(jparams), jparams)
    ref_params = optax.apply_updates(jparams, updates)

    model = TM.NerfactoNuscMS(tcfg, bridge.from_jax_params(params_np))
    optimizers = TOpt.make_optimizers(model.groups(), {
        name: TCfg.OptimizerGroupConfig(**OPT) for name in ("proposal_networks", "fields")})
    metrics = train_step(
        model, optimizers, CameraParams(**{k_: torch.from_numpy(v) for k_, v in cams.items()}),
        {k_: torch.from_numpy(v) for k_, v in batch.items()}, StepScalars(*map(float, scal)),
        stop_prop_grad=False, microbatch_rays=micro,
        prop_grid=None if jgrid is None else torch.from_numpy(np.array(jgrid)),
        draws=_jax_draws(key, k, micro, len(tcfg.num_proposal_samples_per_ray) + 1))

    assert set(metrics) == set(ref)
    for name, v in ref.items():
        np.testing.assert_allclose(metrics[name], float(v), rtol=2e-5, err_msg=name)
    grads = jax.tree_util.tree_leaves(bridge._map(model.params(), lambda t: (
        np.zeros(tuple(t.shape), np.float32) if t.grad is None else t.grad.numpy())))
    params = jax.tree_util.tree_leaves(bridge.to_numpy(model.params()))
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(ref_grads)]
    ref_g = jax.tree_util.tree_leaves(ref_grads)
    before = jax.tree_util.tree_leaves(params_np)
    after = jax.tree_util.tree_leaves(ref_params)
    assert len(grads) == len(params) == len(ref_g) == len(paths)
    checked = 0
    for path, g, got, rg, p0, p1 in zip(paths, grads, params, ref_g, before, after):
        rg = np.asarray(rg)
        scale = np.abs(rg).max()
        np.testing.assert_allclose(g, rg, rtol=0, atol=1e-4 * scale + 1e-30, err_msg=path)
        if "props" in path and ("aabbs" in path or "centroids" in path):
            np.testing.assert_array_equal(got, p0)  # frozen in the port
            assert not np.array_equal(np.asarray(p1), p0)  # moved by JAX's weight decay
            continue
        sel = (np.abs(rg) > 1e-3 * scale) | ((rg == 0) & (g == 0))
        np.testing.assert_allclose(got[sel], np.asarray(p1)[sel], rtol=1e-6, atol=1e-7,
                                   err_msg=path)
        checked += int(sel.sum())
    assert checked > 0.9 * sum(np.size(p) for p in before)


class _StubDataset:
    """The whole dataset as every chunk, for the JAX DataManager."""

    def __init__(self, n):
        from presight_tpu.data.dataset import PixelChunk

        self.chunk = PixelChunk({"rgb": np.zeros((n, 3), np.float32),
                                 "row": np.arange(n)})

    def load_chunk(self, step):
        return self.chunk


class _StubDatasetPort:
    """The whole dataset as every chunk, for the port's DataManager (the
    rule of the in-memory Trainer)."""

    def __init__(self, n):
        self.chunk = TPixelChunk({"rgb": np.zeros((n, 3), np.float32), "row": np.arange(n)})

    def load_chunk(self, step):
        return self.chunk


def test_batch_order_matches_jax_datamanager():
    """The port's DataManager over one in-memory chunk (Trainer.in_memory's
    batch rule) against the JAX DataManager."""
    from presight_tpu.data.datamanager import DataManager

    n, bs, seed = 1000, 96, 42
    dm = DataManager(_StubDataset(n), batch_size=bs, seed=seed)
    port = TDataManager(_StubDatasetPort(n), batch_size=bs, seed=seed)
    try:
        for _ in range(25):  # two and a half chunks
            np.testing.assert_array_equal(port.next_batch()["row"], dm.next_batch()["row"])
    finally:
        dm.close()
        port.close()


def test_adam_schedule_and_update_match_optax():
    """The warmup-multistep factor against JAX's schedule, and one group's
    Adam + LambdaLR over three steps against optax on identical gradients."""
    cfg = TCfg.OptimizerGroupConfig(lr=1e-2, warmup_steps=10, milestones=(4, 8, 30))
    jsched = JOpt.warmup_multistep_schedule(JOpt.OptimizerGroupConfig(**dataclasses.asdict(cfg)))
    for step in range(0, 40, 3):
        np.testing.assert_allclose(cfg.lr * TOpt.warmup_multistep_factor(cfg, step),
                                   float(jsched(step)), rtol=1e-6)
    rng = np.random.RandomState(8)
    p0 = rng.randn(50).astype(np.float32)
    grads = [rng.randn(50).astype(np.float32) for _ in range(3)]
    tx = JOpt.make_group_optimizer(JOpt.OptimizerGroupConfig(**dataclasses.asdict(cfg)))
    jp, js = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = TOpt.GroupOptimizer([tp], cfg)
    for g in grads:
        upd, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("tpu", [True, False], ids=["tpu", "reference"])
def test_tile_trainer_config_matches_method_configs(tpu):
    from presight_tpu.configs.method_configs import build_method_configs
    from presight_tpu.data.datamanager import DataManagerConfig as JDM
    from presight_tpu.engine.trainer import TrainerConfig as JTrainer

    ref = build_method_configs()["boston-seaport-camera-dino-c0" + ("-tpu" if tpu else "")]
    port = TCfg.tile_trainer_config("boston-seaport", 0, "camera", tpu=tpu)
    assert port.microbatch_rays == (1024 if tpu else 4096)
    for name in ("max_num_iterations", "seed", "microbatch_rays"):
        assert getattr(port, name) == getattr(ref, name), name
    assert {k: dataclasses.asdict(v) for k, v in port.optimizers.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref.optimizers.items()}
    assert port.pipeline.datamanager.train_num_rays_per_batch == \
        ref.pipeline.datamanager.train_num_rays_per_batch == 65536
    assert dataclasses.asdict(port.pipeline.model) == dataclasses.asdict(ref.pipeline.model)
    # Defaults of the mirrored fields.
    jt, tt = JTrainer(), TCfg.TrainerConfig()
    for name in ("max_num_iterations", "seed", "microbatch_rays"):
        assert getattr(tt, name) == getattr(jt, name), name
    assert {k: dataclasses.asdict(v) for k, v in tt.optimizers.items()} == \
        {k: dataclasses.asdict(v) for k, v in jt.optimizers.items()}
    assert TCfg.DataManagerConfig().train_num_rays_per_batch == JDM().train_num_rays_per_batch
    assert dataclasses.asdict(TCfg.OptimizerGroupConfig()) == \
        dataclasses.asdict(JOpt.OptimizerGroupConfig())


def test_trainer_loss_decreases():
    """30 steps of the Trainer on the CPU over a tiny in-memory dataset."""
    rng = np.random.RandomState(0)
    cent = (rng.randn(2, 3) * 0.5).astype(np.float32)
    aabbs = np.stack([np.stack([c - 1.5, c + 1.5]) for c in cent]).astype(np.float32)
    n, H, W = 3, 8, 12
    c2w = np.tile(np.eye(3, 4, dtype=np.float32)[None], (n, 1, 1))
    c2w[:, :3, 3] = rng.randn(n, 3) * 0.3
    cams = CameraParams(c2w=torch.from_numpy(c2w), fx=torch.full((n,), 8.0),
                        fy=torch.full((n,), 8.0), cx=torch.full((n,), 6.0),
                        cy=torch.full((n,), 4.0), video_ids=torch.zeros(n, dtype=torch.int32))
    yy, xx = np.mgrid[0:H, 0:W]
    rgb = np.stack([np.stack([0.5 + 0.4 * np.sin(xx / W * 3 + i), 0.5 + 0.4 * np.cos(yy / H * 2),
                              0.4 + 0.0 * xx], -1) for i in range(n)]).astype(np.float32)
    sky = np.zeros((n, H, W), np.float32)
    sky[:, :2] = 1.0
    store = DeviceRayStore(rgb, sky, np.full((n, H, W), -1.0, np.float32),
                           rng.rand(n, H, W, 8).astype(np.float16), device="cpu")
    model = dataclasses.replace(TCfg.NerfactoNuscMSConfig(**TINY), semantic_dim=8,
                                use_lidar_loss=False, proposal_warmup=20,
                                proposal_weights_anneal_max_num_iters=20)
    cfg = TCfg.TrainerConfig(
        max_num_iterations=30, seed=0, microbatch_rays=32,
        pipeline=TCfg.PipelineConfig(datamanager=TCfg.DataManagerConfig(64), model=model),
        optimizers={k: TCfg.OptimizerGroupConfig(**OPT) for k in ("fields", "proposal_networks")})
    trainer = Trainer.in_memory(cfg, store, cams, aabbs, cent, n, 1, device="cpu")
    assert next(trainer.model.parameters()).device.type == "cpu"
    log = []
    trainer.train(callback=lambda step, m: log.append(m))
    losses = [m["total_loss"] for m in log]
    assert len(losses) == 30 and np.isfinite(losses).all(), losses
    assert np.mean(losses[-5:]) < 0.5 * np.mean(losses[:5]), losses
    assert log[0]["grid_refreshed"] == 1.0 and sum(m["grid_refreshed"] for m in log) >= 2
