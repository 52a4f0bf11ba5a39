"""A tiny configuration of the online-mapping cell for the CPU tests: the
published structure (ResNet-50 with DCNv2, 3 FPN levels, 4 z anchors, 8
heads of 32, 8 SCA points, 20 points, one encoder layer, prior fusion) at a
small image, BEV and prior grid, and a 2-layer decoder."""

from __future__ import annotations

import copy

from tiny import SEED  # noqa: F401  (puts the benchmark on sys.path)

from harness import load


def smn():
    cfg = copy.deepcopy(load.config("smn_wcamprior_480_100x50_24e_randomdrop"))
    cfg["model"].update(bev_hw=[10, 20], roi_size=[100.0, 50.0], img_size=[96, 160],
                        num_queries=12, topk_propagate=4, dec_layers=2,
                        prior_pc_range=[-50.0, -25.0, -3.0, 50.0, 25.0, 5.0],
                        prior_voxel_size=[2.5, 2.5, 1.0], prior_max_voxels=300)
    return load.cell("smn-serve-stream"), cfg
