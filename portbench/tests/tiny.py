"""Tiny configurations of the benchmark's cells for the CPU tests: every
width and count cut far below the cells', the structure kept."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import load  # noqa: E402

SEED = 2**31 + 12345  # past 32 signed bits, as the driver's seeds are


def nerf():
    cfg = copy.deepcopy(load.config("boston-seaport-camera-dino-c0"))
    cfg["num_experts"] = 4
    cfg["model"].update(
        num_levels=2, log2_hashmap_size=8, max_res=64, num_proposal_samples_per_ray=[16, 8],
        num_nerf_samples_per_ray=8, semantic_dim=8,
        proposal_net_args_list=[dict(features_per_level=1, log2_hashmap_size=8, num_levels=2,
                                     base_res=16, max_res=64)] * 2)
    cfg["trainer"].update(train_num_rays_per_batch=128, microbatch_rays=64)
    cfg["assumed"]["training_set"].update(samples=4, height=18, width=32)
    return load.cell("nerf-c0-train"), cfg


def occ(cell_name: str):
    cfg = copy.deepcopy(load.config("bevdet-occ-r50d-8x4-24e_wcamprior_randomdrop"))
    cfg["model"].update(
        grid_config={"x": [-8.0, 8.0, 0.8], "y": [-8.0, 8.0, 0.8], "z": [-1.0, 3.0, 0.5],
                     "depth": [1.0, 9.0, 0.5]},
        input_size=[64, 128], view_out_channels=8, neck_channels=32, resnet_base_width=4,
        occ_out_dim=8, prior_pc_range=[-8.0, -8.0, -2.0, 8.0, 8.0, 6.0],
        prior_voxel_size=[0.8, 0.8, 0.8], prior_max_voxels=200)
    cfg["batch_size"] = 2
    return load.cell(cell_name), cfg
