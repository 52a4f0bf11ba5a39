"""The serving slice end to end: presight_tpu_torch's forward(train=False),
forward_depth, point_queries, make_prop_grid, ImageRenderer.render and
extract_voxels against the JAX package on the same weights (carried over by
the bridge), on a tiny -tpu-shaped config: 2 experts, 'shared' storage,
cached grid of resolution 8, shared proposal MLP, <= 16 samples per ray.
JAX functions are jitted: one compile each instead of one per operation.

Tolerances: renders, depths, densities and features atol 1e-5 (rtol 1e-5
where values exceed 1); the prior pickle as stated in
test_extraction_matches_jax. The kernels themselves are checked on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presight_tpu.data import cameras as JC
from presight_tpu.engine import evaluator as JE
from presight_tpu.models import nerfacto_ms as JM
from presight_tpu.ops.rays import RayBundle as JRayBundle
from presight_tpu_torch import bridge, configs as TCfg, kernels
from presight_tpu_torch.data import cameras as TC
from presight_tpu_torch.engine.evaluator import ImageRenderer
from presight_tpu_torch.models import nerfacto_ms as TM
from presight_tpu_torch.ops.rays import RayBundle

TINY = dict(
    near_plane=0.1 * 0.05, far_plane=1000.0 * 0.05, piecewise_sampler_threshold=100.0 * 0.05,
    num_levels=2, base_res=4, max_res=64, log2_hashmap_size=8, features_per_level=2,
    hidden_dim=16, hidden_dim_color=16, num_proposal_samples_per_ray=(16, 12),
    num_nerf_samples_per_ray=8,
    proposal_net_args_list=(dict(features_per_level=2, log2_hashmap_size=7, num_levels=2,
                                 base_res=4, max_res=32),) * 2,
    sky_mlp_dims=8, semantic_dim=64, pose_scale_factor=0.05, hash_storage="shared",
    prop_shared_mlp=True, prop_grid_res=8, remat=False,
)
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(aabbs, cent, num_cameras, num_videos, seed=0):
    """Weights drawn by the port's init_model (from a torch seed), handed to
    JAX by bridge.to_numpy and back to the port by bridge.from_jax_params,
    so both packages run the same values."""
    jcfg, tcfg = JM.NerfactoNuscMSConfig(**TINY), TCfg.NerfactoNuscMSConfig(**TINY)
    init = TM.init_model(torch.Generator().manual_seed(seed), tcfg, aabbs, cent, num_cameras,
                         num_videos, device="cpu")
    params_np = bridge.to_numpy(init.params())
    # Table values well above the 1e-4 init, so densities and colours vary.
    for tree in (params_np["field"], params_np["props"][0]):
        tree["hash_table"] = [t * 3e3 for t in tree["hash_table"]]
    model = TM.NerfactoNuscMS(tcfg, bridge.from_jax_params(params_np))
    return jcfg, jax.tree_util.tree_map(jnp.asarray, params_np), model


def _cameras(rng, n):
    c2w = np.tile(np.eye(3, 4, dtype=np.float32)[None], (n, 1, 1))
    c2w[:, :3, 3] = (rng.randn(n, 3) * 0.3).astype(np.float32)
    kw = dict(c2w=c2w, fx=np.full(n, 8.0, np.float32), fy=np.full(n, 8.0, np.float32),
              cx=np.full(n, 10.0, np.float32), cy=np.full(n, 3.0, np.float32),
              video_ids=rng.randint(0, 2, n).astype(np.int32))
    return (JC.CameraParams(**{k: jnp.asarray(v) for k, v in kw.items()}),
            TC.CameraParams(**{k: _t(v) for k, v in kw.items()}))


@pytest.fixture(scope="module")
def slice_run():
    rng = np.random.RandomState(0)
    cent = (rng.randn(2, 3) * 0.5).astype(np.float32)
    aabbs = np.stack([np.stack([c - 1.5, c + 1.5]) for c in cent]).astype(np.float32)
    jcfg, params, model = _models(aabbs, cent, 6, 2)
    R = 96
    o = (rng.randn(R, 3) * 0.3).astype(np.float32)
    d = rng.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    kw = dict(origins=o, directions=d, nears=np.zeros(R, np.float32),
              fars=np.ones(R, np.float32))
    jb = JRayBundle(**{k: jnp.asarray(v) for k, v in kw.items()})
    tb = RayBundle(**{k: _t(v) for k, v in kw.items()})
    pts = (rng.randn(200, 3) * 1.2).astype(np.float32)
    jcams, tcams = _cameras(rng, 2)

    jgrid = jax.jit(lambda p: JM.make_prop_grid(p, jcfg))(params)
    tgrid = model.make_prop_grid()
    key = jax.random.PRNGKey(0)
    ref = {
        "grid": np.asarray(jgrid),
        "forward": jax.jit(lambda p, b, g: JM.forward(p, jcfg, b, key, 1.0, train=False,
                                                      stop_prop_grad=True, prop_grid=g)
                           )(params, jb, jgrid),
        "depth": jax.jit(lambda p, b, g: JM.forward_depth(p, jcfg, b, key, prop_grid=g)
                         )(params, jb, jgrid),
        "points": jax.jit(lambda p, x, g: JM.point_queries(p, jcfg, x, prop_grid=g)
                          )(params, jnp.asarray(pts), jgrid),
        "image": JE.ImageRenderer(jcfg, chunk=64).render(params, jcams, 1, 6, 20,
                                                         prop_grid=jgrid),
    }
    out = {
        "grid": tgrid.numpy(),
        "forward": model(tb, prop_grid=tgrid),
        "depth": model.forward_depth(tb, prop_grid=tgrid),
        "points": model.point_queries(_t(pts), tgrid),
        "image": ImageRenderer(model.config, chunk=64).render(model, tcams, 1, 6, 20,
                                                              prop_grid=tgrid),
    }
    return ref, out, model


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=ATOL)


def test_make_prop_grid_matches_jax(slice_run):
    ref, out, _ = slice_run
    assert out["grid"].shape == (2 * 8 ** 3, 8)
    _close(out["grid"], ref["grid"])


def test_forward_matches_jax(slice_run):
    ref, out, _ = slice_run
    jo, to = ref["forward"], out["forward"]
    for key in ("rgb", "accumulation", "depth", "expected_depth", "semantics"):
        _close(to[key].numpy(), jo[key])
    # a real scene: the field is neither empty nor saturated everywhere
    acc = to["accumulation"].numpy()
    assert 0.0 < acc.mean() < 1.0
    assert len(to["weights_list"]) == len(jo["weights_list"]) == 2
    for a, b in zip(to["weights_list"], jo["weights_list"]):
        _close(a.numpy(), b)
    for a, b in zip(to["ray_samples_list"], jo["ray_samples_list"]):
        _close(a.starts.numpy(), b.starts)


def test_forward_depth_matches_jax(slice_run):
    ref, out, _ = slice_run
    for key in ("depth", "expected_depth"):
        _close(out["depth"][key].numpy(), ref["depth"][key])


def test_point_queries_matches_jax(slice_run):
    ref, out, _ = slice_run
    (jd, jf), (td, tf) = ref["points"], out["points"]
    _close(td.numpy(), jd)
    _close(tf.numpy(), jf)
    assert tf.shape == (200, 64)


def test_image_renderer_matches_jax(slice_run):
    ref, out, _ = slice_run
    assert set(out["image"]) == set(ref["image"])
    for key, v in ref["image"].items():
        assert out["image"][key].shape == v.shape
        _close(out["image"][key], v)


@pytest.mark.parametrize("change", [dict(prop_grid_res=0), dict(prop_shared_mlp=False)],
                         ids=["hash_field_first_round", "per_expert_proposal_mlps"])
def test_reference_paths_build_and_run(change):
    """Each half of the reference architecture on the -tpu-shaped config:
    the hash-field first proposal round, and per-expert proposal MLPs with
    the cached grid. The model builds, and its eval forward matches JAX's."""
    rng = np.random.RandomState(1)
    cent = (rng.randn(2, 3) * 0.5).astype(np.float32)
    aabbs = np.stack([np.stack([c - 1.5, c + 1.5]) for c in cent]).astype(np.float32)
    kw = dict(TINY, **change)
    jcfg, tcfg = JM.NerfactoNuscMSConfig(**kw), TCfg.NerfactoNuscMSConfig(**kw)
    init = TM.init_model(torch.Generator().manual_seed(0), tcfg, aabbs, cent, 6, 2, device="cpu")
    params_np = bridge.to_numpy(init.params())
    for tree in (params_np["field"], *params_np["props"]):
        tree["hash_table"] = [t * 3e3 for t in tree["hash_table"]]
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    model = TM.NerfactoNuscMS(tcfg, bridge.from_jax_params(params_np))
    assert len(params_np["props"]) == (2 if tcfg.prop_grid_res == 0 else 1)
    R = 48
    d = rng.randn(R, 3).astype(np.float32)
    kw = dict(origins=(rng.randn(R, 3) * 0.3).astype(np.float32),
              directions=d / np.linalg.norm(d, axis=-1, keepdims=True),
              nears=np.zeros(R, np.float32), fars=np.ones(R, np.float32))
    jgrid = jax.jit(lambda p: JM.make_prop_grid(p, jcfg))(params)
    key = jax.random.PRNGKey(0)
    jo = jax.jit(lambda p, b, g: JM.forward(p, jcfg, b, key, 1.0, train=False,
                                            stop_prop_grad=True, prop_grid=g))(
        params, JRayBundle(**{k: jnp.asarray(v) for k, v in kw.items()}), jgrid)
    to = model(RayBundle(**{k: _t(v) for k, v in kw.items()}), prop_grid=model.make_prop_grid())
    for key in ("rgb", "accumulation", "depth", "expected_depth", "semantics"):
        _close(to[key].numpy(), jo[key])
    assert len(to["weights_list"]) == len(jo["weights_list"])


def test_extraction_matches_jax(tmp_path):
    """JAX and port extract_voxels on the synthetic fixture with the same
    weights. Voxel count, hits and origin are identical. Points agree within
    rtol 1e-6 (test_prior_extraction.py's) plus atol 2e-5, two f32 ulps at
    the fixture's ~80-m extent: a coordinate near 0 is a sum of terms that
    large and carries their rounding. F16 features agree within atol 2e-3
    (test_prior_extraction.py's); colours within atol 1e-4, because they
    are computed from the f16 features, and a feature that differs by 1e-7
    before rounding can round to the neighbouring f16 value. None of the
    three is byte-identical in general (sums are taken in another order).
    For the same reason a point within float error of a voxel face may fall
    into the neighbouring voxel in one package and change two voxels' hits:
    the weights' seed is one where no point lies that close (of seeds 0-5,
    seeds 1 and 3 have one such point)."""
    from presight_tpu.data.dataparser import DataParserConfig, make_camera_params, parse
    from presight_tpu.data.synthetic import generate_scene
    from presight_tpu.prior.extraction import extract_voxels as jax_extract
    from presight_tpu_torch.prior.extraction import extract_voxels

    scene_dir = generate_scene(tmp_path / "nusc", num_frames=2, height=24, width=40)
    parsed = parse(DataParserConfig(data_dir=scene_dir, location="synthetic-city", num_aabbs=2,
                                    pose_scale_factor=0.05, depth_type="lidar",
                                    centroids_dir=scene_dir / "centroids"), split="train")
    jcfg, params, model = _models(parsed.aabbs, parsed.centroids, len(parsed.items),
                                  parsed.num_videos, seed=0)
    jcams = make_camera_params(parsed.items)
    tcams = TC.CameraParams(**{k: _t(getattr(jcams, k))
                               for k in ("c2w", "fx", "fy", "cx", "cy", "video_ids")})
    common = dict(pose_scale_factor=parsed.pose_scale_factor, origin=parsed.pose_transformation,
                  dino_to_rgb=parsed.dino_to_rgb, frame_interval=1, density_threshold=0.0,
                  hit_thr_ratio=0.2)
    jax_extract(params=params, config=jcfg, items=parsed.items, cameras=jcams,
                output_dir=tmp_path / "jax", **common)
    with kernels.plain_versions():
        extract_voxels(model, parsed.items, tcams, output_dir=tmp_path / "port", **common)
    with open(tmp_path / "jax" / "extracted_priors.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(tmp_path / "port" / "extracted_priors.pkl", "rb") as f:
        out = pickle.load(f)
    assert set(out) == set(ref) == {"points", "features", "colors", "hits", "origin"}
    for key in ref:
        assert out[key].dtype == ref[key].dtype and out[key].shape == ref[key].shape, key
    assert len(out["points"]) > 0
    np.testing.assert_array_equal(out["hits"], ref["hits"])
    np.testing.assert_array_equal(out["origin"], ref["origin"])
    np.testing.assert_allclose(out["points"], ref["points"], rtol=1e-6, atol=2e-5)
    np.testing.assert_allclose(out["colors"], ref["colors"], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(out["features"].astype(np.float32),
                               ref["features"].astype(np.float32), atol=2e-3)
