"""Prior extraction's per-camera path (prior/extraction.extract_frame_points),
which keeps a camera's hits on the model's device through the density
threshold and the PCA colours, against a plain numpy version of the same
steps: the hits copied to the host after the depth render and after the
point queries, then selected, thresholded, rounded to f16 and coloured in
numpy. Kept points and f16 features are the same bit for bit, colours
within 1e-6 (the (N, 64) x (64, 3) product sums in another order), and the
counts extract_voxels prints are the hits and the kept rows. This file imports no jax: tests/test_torch_cuda.py runs the
same comparison on the card."""

from __future__ import annotations

import contextlib
import io

import numpy as np
import torch

from presight_tpu_torch import configs as TCfg

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


def extraction_fixture(root, device="cpu"):
    """The synthetic two-frame scene at 24 x 40, its cameras and a tiny model
    on ``device`` whose tables are well above the 1e-4 init, so densities
    and features vary from hit to hit."""
    from presight_tpu_torch.data.dataparser import make_camera_params, parse
    from presight_tpu_torch.data.synthetic import generate_scene
    from presight_tpu_torch.models.nerfacto_ms import init_model

    scene = generate_scene(root / "nusc", num_frames=2, height=24, width=40)
    parsed = parse(TCfg.DataParserConfig(
        data_dir=scene, location="synthetic-city", num_aabbs=2, pose_scale_factor=0.05,
        depth_type="lidar", centroids_dir=scene / "centroids"), split="train")
    model = init_model(torch.Generator().manual_seed(0), TCfg.NerfactoNuscMSConfig(**TINY_NERF),
                       parsed.aabbs, parsed.centroids, len(parsed.items), parsed.num_videos,
                       device="cpu")
    params = model.params()
    with torch.no_grad():
        for table in params["field"]["hash_table"] + params["props"][0]["hash_table"]:
            table.mul_(3e3)
    return parsed, model.to(device), make_camera_params(parsed.items, device=device)


@torch.no_grad()
def numpy_hits(model, cameras, camera_idx, H, W, psf, prop_grid, depth_type="depth",
               chunk=1 << 17, max_depth=50.0, min_depth=0.5, z_bounds=(-3.0, 6.0)):
    """One camera's hits through host numpy: (points f32, densities f32,
    features f16)."""
    from presight_tpu_torch.data.cameras import generate_rays
    from presight_tpu_torch.prior.extraction import _pad_to

    device = cameras.c2w.device
    rows, cols = np.nonzero(np.ones((H, W), bool))
    ray_index = np.stack([np.full(len(rows), camera_idx, np.int32), rows.astype(np.int32),
                          cols.astype(np.int32)], axis=-1)
    points, dens, feats = [], [], []
    for s in range(0, len(rows), chunk):
        idx = ray_index[s:s + chunk]
        idx_p = np.pad(idx, ((0, _pad_to(len(idx), 4096) - len(idx)), (0, 0)))
        bundle = generate_rays(cameras, torch.from_numpy(idx_p).to(device))
        outputs = model.forward_depth(bundle, prop_grid=prop_grid)
        depth = outputs[depth_type][: len(idx)].cpu().numpy() / psf
        origins = bundle.origins[: len(idx)].cpu().numpy() / psf
        dirs = bundle.directions[: len(idx)].cpu().numpy()
        world = origins + dirs * depth[:, None]
        sel = ((depth < max_depth) & (depth > min_depth)
               & (world[:, 2] > z_bounds[0]) & (world[:, 2] < z_bounds[1]))
        world = world[sel]
        if len(world) == 0:
            continue
        world_p = np.pad(world, ((0, _pad_to(len(world), 4096) - len(world)), (0, 0)))
        dens_t, feats_t = model.point_queries(
            torch.from_numpy(world_p.astype(np.float32)).to(device) * psf, prop_grid)
        points.append(world.astype(np.float32))
        dens.append(dens_t[: len(world)].cpu().numpy().astype(np.float32))
        feats.append(feats_t[: len(world)].cpu().numpy().astype(np.float16))
    return np.concatenate(points), np.concatenate(dens), np.concatenate(feats)


def numpy_kept(points, dens, feats, dino_to_rgb, density_threshold):
    """The density threshold and the PCA colours in numpy: (kept points f32,
    features f16, colours f32)."""
    keep = dens > density_threshold
    red = np.asarray(dino_to_rgb["reduction_matrix"], np.float32)
    lo = np.asarray(dino_to_rgb["rgb_min"], np.float32)
    hi = np.asarray(dino_to_rgb["rgb_max"], np.float32)
    img = (feats[keep].astype(np.float32) - np.asarray(dino_to_rgb["mean"], np.float32)) @ red
    return points[keep], feats[keep], np.clip((img - lo) / (hi - lo), 0.0, 1.0)


def check_device_path_matches_numpy(root, device="cpu"):
    """The comparison of this file's docstring on ``device``, over the first
    two cameras of a frame by their median depth (extract_voxels' default,
    which extracts as many of a frame's cameras as it is given). The
    threshold is the middle one of camera 0's hits' densities: about half of
    the hits are kept, and the hit at the threshold is not. Returns the kept
    rows."""
    from presight_tpu_torch.prior.extraction import extract_frame_points, extract_voxels
    from presight_tpu_torch.utils.colormaps import colormap_on

    parsed, model, cams = extraction_fixture(root, device)
    items, psf = parsed.items[:2], parsed.pose_scale_factor
    prop_grid = model.make_prop_grid()
    colormap = colormap_on(parsed.dino_to_rgb, cams.c2w.device)
    plain = [numpy_hits(model, cams, ci, item.H, item.W, psf, prop_grid)
             for ci, item in enumerate(items)]
    dens0 = np.sort(plain[0][1])
    thr = float(dens0[len(dens0) // 2])  # a density that one hit has: a tie
    hits = kept = 0
    for ci, (item, (points, dens, feats)) in enumerate(zip(items, plain)):
        want = numpy_kept(points, dens, feats, parsed.dino_to_rgb, thr)
        got = extract_frame_points(model, cams, ci, item.H, item.W, None, psf, colormap,
                                   density_threshold=thr, depth_type="depth",
                                   prop_grid=prop_grid)
        assert got is not None and got[3] == len(points)
        for g, w, dtype in zip(got[:2], want[:2], (np.float32, np.float16)):
            assert g.dtype == w.dtype == dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()
        assert got[2].dtype == np.float32 and got[2].shape == want[2].shape
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)
        hits, kept = hits + len(points), kept + len(want[0])
    assert 0 < kept < hits

    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        extract_voxels(model, items, cams, pose_scale_factor=psf,
                       origin=parsed.pose_transformation, dino_to_rgb=parsed.dino_to_rgb,
                       output_dir=root / "out", density_threshold=thr,
                       use_segmentation_mask=False)
    lines = log.getvalue().splitlines()
    assert f"num hit points before density thr: {hits}" in lines
    assert f"num hit points after density thr: {kept}" in lines
    return kept


def test_device_path_matches_numpy(tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # 960-ray chunks: more threads only contend
    try:
        assert check_device_path_matches_numpy(tmp_path) > 0
    finally:
        torch.set_num_threads(threads)
