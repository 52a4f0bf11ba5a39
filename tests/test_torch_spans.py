"""The port's spans and counters (presight_tpu_torch.utils.profiler): off,
a span is one shared null context and touches no profiler state; inside a
torch.profiler session each unit of work holds every span of its path once,
nested as in the code; the counters count the rows the extraction chunks
send; and the results are the same with the profiler on and off."""

from __future__ import annotations

import contextlib
import dataclasses
import pickle

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from presight_tpu_torch import configs as TCfg
from presight_tpu_torch.utils import profiler

OCC_SPANS = ("occ.forward", "occ.image_encoder", "occ.view_transformer", "occ.bev_encoder")
OCC_TREE = {"occ.train_step": None, "occ.forward": "occ.train_step",
            "occ.image_encoder": "occ.forward", "occ.view_transformer": "occ.forward",
            "occ.bev_encoder": "occ.forward", "occ.optimizer": "occ.train_step"}
EXTRACT_CHILDREN = ("extract.render", "extract.select", "extract.query", "extract.colors",
                    "extract.spill", "extract.fold", "extract.write")
TINY_NERF = dict(
    near_plane=0.1 * 0.05, far_plane=1000.0 * 0.05, piecewise_sampler_threshold=100.0 * 0.05,
    num_levels=2, base_res=4, max_res=64, log2_hashmap_size=8, features_per_level=2,
    hidden_dim=16, hidden_dim_color=16, num_proposal_samples_per_ray=(16, 12),
    num_nerf_samples_per_ray=8,
    proposal_net_args_list=(dict(features_per_level=2, log2_hashmap_size=7, num_levels=2,
                                 base_res=4, max_res=32),) * 2,
    sky_mlp_dims=8, semantic_dim=64, pose_scale_factor=0.05, hash_storage="shared",
    prop_shared_mlp=True, prop_grid_res=8, remat=False,
)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.split(".")[0] in
                 ("occ", "extract", "trainer", "nerf")]


def _by_name(events):
    out = {}
    for e in events:
        out.setdefault(e.name, []).append(e)
    return out


def _inside(child, parents) -> bool:
    return any(p.time_range.start <= child.time_range.start
               and child.time_range.end <= p.time_range.end for p in parents)


def _occ_setup(seed=0):
    from presight_tpu_torch.models.layers import init_weights
    from presight_tpu_torch.occupancy import BEVDetOcc, BEVDetOccConfig
    from presight_tpu_torch.scripts import train_occ
    from presight_tpu_torch.utils.ema import ema_init

    cfg = BEVDetOccConfig(
        grid_config=train_occ.GRID, input_size=train_occ.INPUT_SIZE, downsample=16,
        view_out_channels=16, img_widths=(8, 16, 16, 32), neck_channels=32, bev_widths=(16, 32),
        bev_out_channels=16, occ_out_dim=16, num_classes=18, temporal=True)
    model = BEVDetOcc(cfg, device="cpu", with_prior_fusion=False)
    init_weights(model, torch.Generator().manual_seed(seed))
    optimizer = train_occ.make_optimizer(model, 1e-3, 1e-2)
    batch = train_occ.to_device(train_occ.toy_batch(seed), "cpu")
    return model, optimizer, ema_init(model), batch


def _occ_step(seed=0):
    from presight_tpu_torch.scripts import train_occ

    model, optimizer, ema, batch = _occ_setup(seed)
    loss, _ = train_occ.train_step(model, optimizer, ema, batch)
    return loss


def test_span_off_is_one_shared_null_context_and_leaves_the_profiler_alone():
    from torch.autograd import profiler as autograd_profiler

    assert not autograd_profiler._is_profiler_enabled
    first, second = profiler.span("occ.forward"), profiler.span("extract.frame")
    assert first is second and isinstance(first, contextlib.nullcontext)
    with first as entered:
        assert entered is None
    assert not autograd_profiler._is_profiler_enabled
    assert not torch.autograd._profiler_enabled()


def test_span_on_is_a_profiler_range_nested_in_its_parent():
    def nested():
        with profiler.span("trainer.step"):
            with profiler.span("trainer.batch"):
                torch.ones(3).sum()

    _, events = _profiled(nested)
    got = _by_name(events)
    assert sorted(got) == ["trainer.batch", "trainer.step"]
    assert got["trainer.batch"][0].cpu_parent.name == "trainer.step"
    assert _inside(got["trainer.batch"][0], got["trainer.step"])


@pytest.mark.parametrize("steps", [1, 2])
def test_occ_train_step_holds_every_span_once_per_step(steps):
    from presight_tpu_torch.scripts import train_occ

    model, optimizer, ema, batch = _occ_setup()

    def run():
        nonlocal ema
        for _ in range(steps):
            _, ema = train_occ.train_step(model, optimizer, ema, batch)

    _, events = _profiled(run)
    got = _by_name(events)
    assert {k: len(v) for k, v in got.items()} == dict.fromkeys(OCC_TREE, steps)
    for name, parent in OCC_TREE.items():
        if parent is not None:
            assert all(_inside(e, got[parent]) for e in got[name]), name
            assert all(e.cpu_parent is not None and e.cpu_parent.name == parent
                       for e in got[name]), name


def test_occ_eval_forward_holds_the_model_spans_once():
    model, _, _, batch = _occ_setup()
    from presight_tpu_torch.scripts import train_occ

    def run():
        with torch.no_grad():
            return model(*[batch[k] for k in train_occ._MODEL_INPUTS])[0]

    _, events = _profiled(run)
    got = _by_name(events)
    assert {k: len(v) for k, v in got.items()} == dict.fromkeys(OCC_SPANS, 1)
    for name in OCC_SPANS[1:]:
        assert _inside(got[name][0], got["occ.forward"])


def test_occ_step_loss_is_the_same_with_the_profiler_on_and_off():
    off = _occ_step()
    on, _ = _profiled(_occ_step)
    assert torch.equal(off, on)


def _trainer():
    from presight_tpu_torch.data.cameras import CameraParams
    from presight_tpu_torch.data.device_store import DeviceRayStore
    from presight_tpu_torch.engine.trainer import Trainer

    rng = np.random.RandomState(0)
    cent = (rng.randn(2, 3) * 0.5).astype(np.float32)
    aabbs = np.stack([np.stack([c - 1.5, c + 1.5]) for c in cent]).astype(np.float32)
    n, H, W = 2, 8, 12
    c2w = np.tile(np.eye(3, 4, dtype=np.float32)[None], (n, 1, 1))
    c2w[:, :3, 3] = rng.randn(n, 3) * 0.3
    cams = CameraParams(c2w=torch.from_numpy(c2w), fx=torch.full((n,), 8.0),
                        fy=torch.full((n,), 8.0), cx=torch.full((n,), 6.0),
                        cy=torch.full((n,), 4.0), video_ids=torch.zeros(n, dtype=torch.int32))
    store = DeviceRayStore(rng.rand(n, H, W, 3).astype(np.float32),
                           np.zeros((n, H, W), np.float32),
                           np.full((n, H, W), -1.0, np.float32),
                           rng.rand(n, H, W, 8).astype(np.float16), device="cpu")
    model = dataclasses.replace(TCfg.NerfactoNuscMSConfig(**TINY_NERF), semantic_dim=8,
                                use_lidar_loss=False)
    cfg = TCfg.TrainerConfig(
        max_num_iterations=10, seed=0, microbatch_rays=16,
        pipeline=TCfg.PipelineConfig(datamanager=TCfg.DataManagerConfig(32), model=model))
    return Trainer.in_memory(cfg, store, cams, aabbs, cent, n, 1, device="cpu")


def test_trainer_step_holds_its_spans_once_per_step_and_microbatch():
    trainer = _trainer()
    _, events = _profiled(lambda: trainer.train(num_steps=2))
    got = _by_name(events)
    assert {k: len(v) for k, v in got.items()} == {
        "trainer.step": 2, "trainer.batch": 2, "nerf.forward": 4, "nerf.backward": 4,
        "nerf.optimizer": 2, "nerf.metrics": 2}
    for name in ("trainer.batch", "nerf.forward", "nerf.backward", "nerf.optimizer",
                 "nerf.metrics"):
        assert all(_inside(e, got["trainer.step"]) for e in got[name]), name


def _extraction(tmp_path):
    from presight_tpu_torch.data.dataparser import make_camera_params, parse
    from presight_tpu_torch.data.synthetic import generate_scene
    from presight_tpu_torch.models.nerfacto_ms import init_model

    scene = generate_scene(tmp_path / "nusc", num_frames=2, height=24, width=40)
    parsed = parse(TCfg.DataParserConfig(
        data_dir=scene, location="synthetic-city", num_aabbs=2, pose_scale_factor=0.05,
        depth_type="lidar", centroids_dir=scene / "centroids"), split="train")
    model = init_model(torch.Generator().manual_seed(0), TCfg.NerfactoNuscMSConfig(**TINY_NERF),
                       parsed.aabbs, parsed.centroids, len(parsed.items), parsed.num_videos,
                       device="cpu")
    return parsed, model, make_camera_params(parsed.items, device="cpu")


def _extract(parsed, model, cams, out):
    from presight_tpu_torch.prior.extraction import extract_voxels

    extract_voxels(model, parsed.items[:6], cams, pose_scale_factor=parsed.pose_scale_factor,
                   origin=parsed.pose_transformation, dino_to_rgb=parsed.dino_to_rgb,
                   output_dir=out, density_threshold=0.0, use_segmentation_mask=False)
    return (out / "extracted_priors.pkl").read_bytes()


def test_extraction_spans_counters_and_bytes(tmp_path, capsys):
    from presight_tpu_torch.prior.extraction import _pad_to

    parsed, model, cams = _extraction(tmp_path)
    items = parsed.items[:6]
    off = _extract(parsed, model, cams, tmp_path / "off")
    capsys.readouterr()
    before = dict(profiler.COUNTS)
    on, events = _profiled(lambda: _extract(parsed, model, cams, tmp_path / "on"))
    hits = int(capsys.readouterr().out.split("before density thr: ")[1].split()[0])
    delta = {k: profiler.COUNTS[k] - before.get(k, 0) for k in profiler.COUNTS}

    assert off == on and len(pickle.loads(on)["points"]) > 0
    got = _by_name(events)
    assert len(got["extract.frame"]) == 1
    assert {"extract.frame", *EXTRACT_CHILDREN} <= set(got)
    for name in EXTRACT_CHILDREN:
        assert all(_inside(e, got["extract.frame"]) for e in got[name]), name
    assert len(got["extract.render"]) == len(items)  # one chunk a camera at this size
    pixels = [item.H * item.W for item in items]
    assert delta["extract.rays"] == sum(pixels)
    assert delta["extract.rays_padded"] == sum(_pad_to(p, 4096) for p in pixels)
    assert delta["extract.points"] == hits > 0
    assert delta["extract.points_padded"] % 4096 == 0
    assert delta["extract.points"] <= delta["extract.points_padded"] < (
        delta["extract.points"] + 4096 * len(items))
