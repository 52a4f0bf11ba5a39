"""Named stage-3 configs, the port of ``occ_configs`` and ``map_configs``
in presight_tpu/configs/stage3_configs.py: each entry returns the
:class:`~presight_tpu_torch.occupancy.BEVDetOccConfig` or
:class:`~presight_tpu_torch.mapping.StreamMapNetConfig` of the model that
the JAX entry of the same name builds, field for field. A config carrying a
reference config file's name builds the reference topology (ResNet-50 +
CustomFPN + CustomResNet3D/LSSFPN3D; ResNet-50 with DCNv2 + FPN + BEVFormer
for StreamMapNet); the strided-conv stand-ins are the ``*-toy`` entries.
"""

from __future__ import annotations

from typing import Callable, Dict

from ..mapping.stream_mapnet import StreamMapNetConfig
from ..occupancy.bevdet_occ import BEVDetOccConfig

# bevdet-occ-r50d-8x4-24e_wcamprior_randomdrop.py:52-57 grid_config.
_OCC_GRID = {
    "x": (-40.0, 40.0, 0.4),
    "y": (-40.0, 40.0, 0.4),
    "z": (-1.0, 5.4, 0.4),
    "depth": (1.0, 45.0, 0.5),
}
# :61-62 prior ranges; :131-139 fusion module cfg.
_OCC_PRIOR_PC_RANGE = (-40.0, -40.0, -2.0, 40.0, 40.0, 6.0)
_OCC_PRIOR_VOXEL_SIZE = (0.4, 0.4, 0.4)

# train_occ's toy scales.
_TOY_OCC_GRID = {
    "x": (-8.0, 8.0, 0.8),
    "y": (-8.0, 8.0, 0.8),
    "z": (-1.0, 3.0, 0.5),
    "depth": (1.0, 9.0, 0.5),
}


def _occ_reference() -> BEVDetOccConfig:
    """BEVStereo4DOCC at the reference scale (config :68-141): ResNet-50
    out_indices (0, 2, 3) -> CustomFPN(1024 + 2048 -> 256) -> LSS with
    stereo (numC_Trans 32, downsample 16, 88 depth bins) -> CustomResNet3D
    (1, 2, 4 layers; 32/64/128; strides 1/2/2) -> LSSFPN3D(7 * 32 -> 32),
    temporal (num_adj 1), voxel prior fusion, 18-class occupancy head."""
    return BEVDetOccConfig(
        grid_config=_OCC_GRID,
        input_size=(256, 704),
        downsample=16,
        view_out_channels=32,
        neck_channels=256,
        backbone="resnet",
        resnet_depth=50,
        resnet_base_width=64,
        bev_neck="lssfpn3d",
        bev_out_channels=32,
        occ_out_dim=32,
        num_classes=18,
        prior_pc_range=_OCC_PRIOR_PC_RANGE,
        prior_voxel_size=_OCC_PRIOR_VOXEL_SIZE,
        prior_in_channels=68,
        prior_fusion="voxel",
        temporal=True,
        stereo=True,
    )


def _occ_toy() -> BEVDetOccConfig:
    """The strided-conv stand-in at CI widths (scripts/train_occ.py)."""
    return BEVDetOccConfig(
        grid_config=_TOY_OCC_GRID, input_size=(32, 64), downsample=16,
        view_out_channels=16, img_widths=(8, 16, 16, 32), neck_channels=32,
        bev_widths=(16, 32), bev_out_channels=16, occ_out_dim=16,
        num_classes=18,
    )


occ_configs: Dict[str, Callable[[], BEVDetOccConfig]] = {
    "bevdet-occ-r50d-8x4-24e_wcamprior_randomdrop": _occ_reference,
    "bevdet-occ-toy": _occ_toy,
}


# smn_wcamprior_480_100x50_24e_randomdrop.py :38-43.
_MAP_ROI_SIZE = (100.0, 50.0)
_MAP_PRIOR_PC_RANGE = (-50.0, -25.0, -3.0, 50.0, 25.0, 5.0)
_MAP_PRIOR_VOXEL_SIZE = (0.5, 0.5, 0.5)


def _smn_reference() -> StreamMapNetConfig:
    """StreamMapNet at the reference scale (smn config :71-265): ResNet-50
    with DCNv2 at stages 3-4 (:93-94) + 3-level FPN (:95-103) -> BEVFormer
    encoder (bev 50x100, embed 256, 4 z anchors, 1 layer :109-126) ->
    streaming ConvGRU BEV (:233-239) + 2D voxel prior fusion (:241-248) ->
    MapDetectorHead (100 queries, 20 points, 3 classes, 6 layers, top-33
    propagation :144-172), 8 heads; the per-camera SCA query compaction at
    half the BEV queries (a camera's frustum covers well under half of the
    100 x 50 m plane)."""
    return StreamMapNetConfig(
        bev_hw=(50, 100), roi_size=_MAP_ROI_SIZE, img_size=(480, 800), embed_dim=256,
        num_queries=100, num_points=20, num_classes=3, streaming_bev=True, topk_propagate=33,
        num_levels=3, num_z_anchors=4, backbone="resnet", dcn=True, enc_layers=1,
        dec_layers=6, num_heads=8, sca_capacity_frac=0.5,
        prior_pc_range=_MAP_PRIOR_PC_RANGE, prior_voxel_size=_MAP_PRIOR_VOXEL_SIZE,
        prior_voxel_channels=68)


def _smn_toy() -> StreamMapNetConfig:
    """Stand-in widths for CI and the smoke CLIs."""
    return StreamMapNetConfig(img_size=(32, 64))


def _raster_reference():
    raise NotImplementedError(
        "nusc_raster_wcamprior_480_100x50_24e_randomdrop (RasterMapper) is not ported yet: "
        "ROADMAP Queue 1 item 4(d)")


map_configs: Dict[str, Callable[[], StreamMapNetConfig]] = {
    "smn_wcamprior_480_100x50_24e_randomdrop": _smn_reference,
    "nusc_raster_wcamprior_480_100x50_24e_randomdrop": _raster_reference,
    "smn-toy": _smn_toy,
}
