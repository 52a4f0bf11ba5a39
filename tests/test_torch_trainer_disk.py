"""The port's Trainer from disk (presight_tpu_torch/engine/trainer.py
``setup``/``train``/``eval_setup``), its checkpoints and its train CLI,
against the JAX package's Trainer on the JAX package's synthetic fixture,
at a tiny model size on the CPU.

  * the first batch equals the JAX Trainer's, bit for bit (host rows and
    the device store's gather);
  * on the JAX Trainer's initial weights (carried across by the bridge),
    its cached grid and its own draws, the first step's losses are within
    rtol 2e-5 of JAX's (test_torch_train.py's tolerance: sums of a few
    hundred terms in another order), the total less the sky loss too; the
    sky loss, on saturated rays, ray by ray: each accumulation within
    S * 2^-24 of JAX's, the port's loss at rtol 2e-5 of the float64 BCE of
    its accumulations, and the two losses within the BCE change that the
    measured per-ray gaps (each plus one ulp) give;
  * a checkpoint round trip is bit-exact: parameters, Adam moments and
    steps, schedulers, the step;
  * the four lifecycle behaviours of tests/test_trainer_resume.py: a rerun
    below the trained step, the resume offsets, zero cadences, eval_setup
    leaving config.yml alone;
  * the run's config.yml loads with the JAX package's load_config; the CLI
    lists the JAX names and trains.
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from presight_tpu.configs import config_io as JIO
from presight_tpu.configs.method_configs import method_configs as JAX_METHODS
from presight_tpu.data.synthetic import generate_scene as jax_generate_scene
from presight_tpu_torch import bridge
from presight_tpu_torch.configs import config_io as TIO
from presight_tpu_torch.configs.method_configs import method_configs as PORT_METHODS
from presight_tpu_torch.data.cameras import generate_rays
from presight_tpu_torch.engine import trainer as TT
from presight_tpu_torch.engine.checkpoints import latest_checkpoint, save_checkpoint
from presight_tpu_torch.engine.train_step import train_step
from presight_tpu_torch.models.nerfacto_ms import NerfactoNuscMS
from presight_tpu_torch.scripts import train as train_cli
from test_torch_slice import TINY
from test_torch_train import _jax_draws

MODEL = {k: v for k, v in TINY.items() if k != "pose_scale_factor"}


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    return jax_generate_scene(tmp_path_factory.mktemp("synthetic"))


def _config(methods, root, out, **fields):
    """synthetic-demo over ``root`` at the tiny model size: 64-ray steps in
    microbatches of 32, chunks of 4 images, outputs under ``out``."""
    cfg = methods["synthetic-demo"]
    p = cfg.pipeline
    pipeline = dataclasses.replace(
        p,
        dataparser=dataclasses.replace(p.dataparser, data_dir=root,
                                       centroids_dir=root / "centroids"),
        datamanager=dataclasses.replace(p.datamanager, train_num_rays_per_batch=64,
                                        eval_num_rays_per_batch=64, images_per_chunk=4,
                                        num_threads=2),
        model=dataclasses.replace(p.model, **MODEL))
    base = dict(max_num_iterations=6, steps_per_save=100, steps_per_eval_batch=0,
                steps_per_eval_image=1000, output_dir=out, timestamp="test", num_devices=1,
                microbatch_rays=32, eval_lpips=False)
    base.update(fields)
    return dataclasses.replace(cfg, pipeline=pipeline, **base)


def _port(root, out, **fields):
    return _config(PORT_METHODS, root, out, **fields)


def _port_accumulation(trainer, batch, draws, grid, scalars) -> np.ndarray:
    """Each ray's accumulation in the port's first step (its forward on the
    step's draws, microbatch by microbatch)."""
    micro = len(batch["ray_index"]) // len(draws)
    accs = []
    for i, uniforms in enumerate(draws):
        idx = batch["ray_index"][i * micro:(i + 1) * micro]
        out = trainer.model(generate_rays(trainer.cameras, idx), train=True, prop_grid=grid,
                            anneal=scalars.anneal, uniforms=uniforms, stop_prop_grad=True)
        accs.append(out["accumulation"].detach().reshape(-1).numpy())
    return np.concatenate(accs)


def _jax_accumulation(params, config, cameras, batch, key, k, anneal, grid, stop_prop_grad):
    """Each ray's accumulation in the JAX step's forward: microbatch i on
    key i of split(key, k), as the split-update step draws them."""
    from presight_tpu.data.cameras import generate_rays as jax_generate_rays
    from presight_tpu.models import nerfacto_ms as JM

    forward = jax.jit(lambda p, b, rng, g: JM.forward(
        p, config, b, rng, anneal, train=True, stop_prop_grad=stop_prop_grad,
        prop_grid=g)["accumulation"])
    keys = [key] if k == 1 else list(jax.random.split(key, k))
    micro = len(batch["ray_index"]) // k
    return np.concatenate([np.asarray(forward(
        params, jax_generate_rays(cameras, batch["ray_index"][i * micro:(i + 1) * micro]),
        rng, grid)).reshape(-1) for i, rng in enumerate(keys)])


def _sky_bce(acc: np.ndarray, sky: np.ndarray) -> np.ndarray:
    """The per-ray BCE of ops/losses.sky_loss in float64 after its float32
    clip (1 - 1e-7 rounds to 1 - 2^-23 in float32)."""
    from presight_tpu_torch.ops.losses import EPS

    a = np.clip(acc.astype(np.float32), np.float32(EPS), np.float32(1.0) - np.float32(EPS))
    a = a.astype(np.float64)
    return np.where(sky, -np.log1p(-a), -np.log(a))


def test_first_batch_and_step_match_jax(fixture_dir, tmp_path):
    from presight_tpu.engine.trainer import Trainer as JTrainer
    from presight_tpu.models import nerfacto_ms as JM

    jt = JTrainer(_config(JAX_METHODS, fixture_dir, tmp_path / "jax"))
    jt.setup()
    pt = TT.Trainer(_port(fixture_dir, tmp_path / "port"), device="cpu")
    pt.setup()
    try:
        ref_np, got_np = jt.datamanager.next_batch(), pt.datamanager.next_batch()
        assert sorted(got_np) == sorted(ref_np)
        for k in ref_np:
            np.testing.assert_array_equal(got_np[k], ref_np[k], err_msg=k)
        ref, got = jt._make_batch(ref_np), pt._make_batch(got_np)
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)

        mcfg = jt.model_config
        grid = JM.make_prop_grid(jt.state.params, mcfg)
        _, sub = jax.random.split(jt._rng)
        scalars = jt._scalars_at(0)
        updated = jt.update_sched.updated(0)
        params = jax.tree_util.tree_map(np.array, jt.state.params)  # the step donates them
        _, ref_metrics = jt.steps(jt.state, jt.cameras, ref, sub, scalars,
                                  stop_prop_grad=not updated, prop_grid=grid)
        micro = pt.config.microbatch_rays
        k = 64 // micro
        acc_jax = _jax_accumulation(params, mcfg, jt.cameras, ref, sub, k, scalars.anneal, grid,
                                    not updated)
        pt.model = NerfactoNuscMS(pt.model_config, bridge.from_jax_params(params))
        optimizers = TT.make_optimizers(pt.model.groups(), pt.config.optimizers)
        draws = _jax_draws(sub, k, micro, len(mcfg.num_proposal_samples_per_ray) + 1)
        scalars = TT.step_scalars(pt.model_config, 0)
        grid = torch.from_numpy(np.array(grid))
        acc = _port_accumulation(pt, got, draws, grid, scalars)
        metrics = train_step(
            pt.model, optimizers, pt.cameras, got, scalars,
            stop_prop_grad=not pt.update_sched.updated(0), microbatch_rays=micro,
            prop_grid=grid, draws=draws)
        assert set(metrics) == set(ref_metrics)
        for name, v in ref_metrics.items():
            if name not in ("sky_loss", "total_loss"):
                np.testing.assert_allclose(metrics[name], float(v), rtol=2e-5, err_msg=name)
        ref_sky, ref_total = float(ref_metrics["sky_loss"]), float(ref_metrics["total_loss"])
        np.testing.assert_allclose(metrics["total_loss"] - metrics["sky_loss"],
                                   ref_total - ref_sky, rtol=2e-5)
        # The sky loss. The fixture's rays saturate at this initialisation
        # (1 - a down to 6e-8 on sky rays), where -log(1 - a) turns one ulp
        # of a into a large change of the loss. So: each ray's accumulation
        # (a sum of S sample weights) within S * 2^-24 of JAX's; the port's
        # loss at rtol 2e-5 of the float64 BCE of its own accumulations; and
        # the two losses within the change of the BCE that the measured
        # per-ray gaps give, each gap widened by 2^-24 (the ulp of a below
        # 1), since the JAX step's fused program may round a saturated
        # accumulation to a neighbour of its separately compiled forward's.
        sky = got_np["sky"] > 0
        gap = np.abs(acc.astype(np.float64) - acc_jax)
        assert gap.max() <= mcfg.num_nerf_samples_per_ray * 2.0 ** -24
        mult = pt.model_config.sky_loss_mult
        bce = _sky_bce(acc, sky)
        np.testing.assert_allclose(metrics["sky_loss"], mult * bce.mean(), rtol=2e-5)
        width = gap + 2.0 ** -24
        per_ray = np.maximum(np.abs(_sky_bce(np.clip(acc - width, 0, 1), sky) - bce),
                             np.abs(_sky_bce(np.clip(acc + width, 0, 1), sky) - bce))
        np.testing.assert_allclose(metrics["sky_loss"], ref_sky, rtol=2e-5,
                                   atol=mult * per_ray.mean())
    finally:
        jt.datamanager.close()
        pt.close()


def test_checkpoint_round_trip_is_bit_exact(fixture_dir, tmp_path):
    cfg = _port(fixture_dir, tmp_path)
    t1 = TT.Trainer(cfg, device="cpu")
    t1.setup()
    t1.train(num_steps=2)
    path = save_checkpoint(t1.run_dir, 2, t1.model, t1.optimizers)
    assert path.is_dir() and path.name == "step-000000002.ckpt"
    t2 = TT.Trainer(cfg, device="cpu")
    t2.setup()
    try:
        assert t2.start_step == t2.step == 2
        for a, b in zip(t1.model.leaves, t2.model.leaves):
            assert torch.equal(a, b)
        for name, opt in t1.optimizers.items():
            other = t2.optimizers[name]
            assert opt.scheduler.state_dict() == other.scheduler.state_dict()
            for p1, p2 in zip(opt.params, other.params):
                s1, s2 = opt.adam.state[p1], other.adam.state[p2]
                assert sorted(s1) == sorted(s2) and s1
                for key in s1:
                    assert torch.equal(s1[key], s2[key]), key
    finally:
        t1.close()
        t2.close()


def test_rerun_below_trained_step_keeps_newest_checkpoint(fixture_dir, tmp_path):
    cfg = _port(fixture_dir, tmp_path)
    t1 = TT.Trainer(cfg, device="cpu")
    t1.setup()
    t1.train()
    assert latest_checkpoint(t1.run_dir).name == "step-000000006.ckpt"
    t2 = TT.Trainer(dataclasses.replace(cfg, max_num_iterations=3), device="cpu")
    t2.setup()
    assert t2.start_step == 6
    t2.train()
    assert latest_checkpoint(t2.run_dir).name == "step-000000006.ckpt"


def test_resume_continues_chunk_stream_and_rng(fixture_dir, tmp_path):
    cfg = _port(fixture_dir, tmp_path, steps_per_save=4)
    t1 = TT.Trainer(cfg, device="cpu")
    t1.setup()
    t1.train()
    ckpts = sorted(p.name for p in (t1.run_dir / "nerfstudio_models").iterdir())
    assert ckpts == ["step-000000006.ckpt"]  # the step-4 save rotated out
    t2 = TT.Trainer(dataclasses.replace(cfg, max_num_iterations=9), device="cpu")
    t2.setup()
    assert t2.start_step == 6
    assert t2.datamanager._chunk_step == cfg.seed + 6
    t0 = TT.Trainer(dataclasses.replace(cfg, output_dir=tmp_path / "fresh"), device="cpu")
    t0.setup()
    assert not torch.equal(t2.generator.get_state(), t0.generator.get_state())
    assert t2.update_sched._steps_since_update == t1.update_sched._steps_since_update
    t2.train()
    assert latest_checkpoint(t2.run_dir).name == "step-000000009.ckpt"
    t0.close()


def test_zero_cadences_disable_instead_of_crash(fixture_dir, tmp_path):
    cfg = _port(fixture_dir, tmp_path, steps_per_save=0, steps_per_eval_image=0,
                steps_per_eval_batch=0, max_num_iterations=3)
    t = TT.Trainer(cfg, device="cpu")
    t.setup()
    t.train()
    assert latest_checkpoint(t.run_dir) is not None


def test_eval_setup_leaves_config_untouched(fixture_dir, tmp_path):
    cfg = _port(fixture_dir, tmp_path, steps_per_eval_batch=2, steps_per_eval_image=5)
    t1 = TT.Trainer(cfg, device="cpu")
    t1.setup()
    t1.train()
    config_path = t1.run_dir / "config.yml"
    before = config_path.read_bytes()
    loaded, trainer = TT.eval_setup(config_path, device="cpu")
    try:
        assert config_path.read_bytes() == before
        assert trainer.run_dir == t1.run_dir and trainer.start_step == 6
        assert loaded == dataclasses.replace(cfg, load_dir=t1.run_dir)
        # The JAX package reads the port's run directory.
        jax_cfg = JIO.load_config(config_path)
        assert JIO.to_dict(jax_cfg) == JIO.to_dict(_config(JAX_METHODS, fixture_dir, tmp_path,
                                                           steps_per_eval_batch=2,
                                                           steps_per_eval_image=5))
    finally:
        trainer.close()


def test_unported_fields_raise(fixture_dir, tmp_path):
    for fields in (dict(num_devices=2), dict(camera_optimizer_mode="so3xr3"),
                   dict(gradient_accumulation_steps=2)):
        with pytest.raises(NotImplementedError):
            TT.Trainer(_port(fixture_dir, tmp_path, **fields), device="cpu").setup()


def test_cli_lists_and_trains(fixture_dir, tmp_path, capsys):
    assert train_cli.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == sorted(JAX_METHODS)
    assert train_cli.main(["--help"]) == 0
    assert train_cli.main(["no-such-method"]) == 1
    argv = ["synthetic-demo", "--pipeline.dataparser.data-dir", str(fixture_dir),
            "--pipeline.dataparser.centroids-dir", str(fixture_dir / "centroids"),
            "--output-dir", str(tmp_path), "--max-num-iterations", "2",
            "--pipeline.datamanager.train-num-rays-per-batch", "64", "--microbatch-rays", "64",
            "--steps-per-eval-batch", "0", "--eval-lpips", "false"]
    assert train_cli.main(argv, device="cpu") == 0
    runs = list(Path(tmp_path, "synthetic-demo", "synthetic-demo").iterdir())
    assert len(runs) == 1
    assert latest_checkpoint(runs[0]).name == "step-000000002.ckpt"
    assert (runs[0] / "config.yml").exists() and (runs[0] / "events.jsonl").exists()


def test_chip_smoke_quality_run_is_the_quality_study_run(tmp_path):
    """chip_smoke.py phase 15 trains quality_study.run_variant's config of
    the shipped profile (tests/test_quality_floor.py) without the JAX
    package: the same config, field for field."""
    import chip_smoke
    from presight_tpu.scripts.quality_study import variant_model
    from test_quality_floor import shipped_profile_variant

    iters = chip_smoke.QUALITY_ITERS
    base = JAX_METHODS["synthetic-demo"]
    model = dataclasses.replace(
        variant_model(base.pipeline.model, shipped_profile_variant()),
        eval_num_rays_per_chunk=1 << 12, proposal_warmup=iters // 4,
        proposal_weights_anneal_max_num_iters=iters // 4, line_of_sight_start_step=iters // 4,
        line_of_sight_end_step=iters, line_of_sight_decay_steps=iters)
    data = tmp_path / "data"
    pipeline = dataclasses.replace(
        base.pipeline, model=model,
        dataparser=dataclasses.replace(base.pipeline.dataparser, data_dir=data,
                                       centroids_dir=data / "centroids"))
    ref = dataclasses.replace(
        base, max_num_iterations=iters, device_ray_store_mb=2048, steps_per_save=max(iters, 100),
        steps_per_eval_batch=0, steps_per_eval_image=10 ** 9, seed=42,
        experiment_name=f"quality-{shipped_profile_variant()}-s42", output_dir=tmp_path,
        timestamp="study", pipeline=pipeline)
    got = chip_smoke.quality_config(data, tmp_path)
    assert TIO.to_dict(got) == JIO.to_dict(ref)
