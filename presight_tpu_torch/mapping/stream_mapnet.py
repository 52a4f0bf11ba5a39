"""StreamMapNet with the prior-fusion hook, served frame by frame: the port
of presight_tpu/mapping/stream_mapnet.py's ``StreamMapNet`` (reference
online-mapping/plugin/models/mapers/StreamMapNet.py :72-73, 160-230:
BEVFormer backbone -> streaming ConvGRU BEV memory -> PriorFusion2D on the
BEV -> MapDetectorHead), with the eval loop's top-k hand-off
(presight_tpu/scripts/train_map.py:163-215) inside the forward.

A forward runs its convolutions and matrix products in IEEE float32, each
convolution on the cuDNN engine that timed fastest at its shape
(``utils.precision.tuned_convolutions``), and is spanned
(utils/profiler.py): ``map.forward`` around it all; ``map.image_encoder``
(ResNet, DCN, FPN), ``map.bev_encoder``, ``map.stream`` (warp and
ConvGRU), ``map.prior_fusion``, ``map.head`` (decoder and the propagation
pre-pass) and ``map.propagate`` (the top-k hand-off) in turn; ``map.msda``
and ``map.dcn_im2col`` around each S3 launch. Inside a profiler session it
counts after the hand-off, per encoder layer, ``map.sca_pairs`` (valid
(camera, query) pairs), ``map.sca_slots`` (cameras x capacity: the pairs
S3 computes) and ``map.sca_overflow`` (valid queries dropped past the
capacity), reading the per-camera counts from the card once a frame, when
its work is queued; outside one it reads nothing from the card.
``map.conv_tuned`` always counts: the model's convolution calls under
cuDNN's timing whose key (input shape, weight shape, stride, padding,
dtype) the process's mapping models had not met, each one cuDNN
measurement on the card (a stream's first two frames; 0 a frame after
them). A set lookup a convolution; it reads nothing from the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models.layers import Conv
from ..models.prior_fusion import PriorFusion2D
from ..utils.precision import ieee_convolutions, ieee_matmul, tuned_convolutions
from ..utils.profiler import count, profiling, span
from .bev_encoder import BEVEncoder
from .conv_gru import ConvGRU, warp_bev
from .map_head import MapDetectorHead, select_topk_for_propagation


# cuDNN's keys of the convolutions the process's mapping models have met:
# cuDNN keeps one plan a key for the process, so it times a key only the
# first time, and only if that time is under its timing.
_CONV_KEYS: set = set()


def _count_tuned(conv: Conv, args: tuple) -> None:
    """A forward pre-hook of each of the model's convolutions: counts
    ``map.conv_tuned`` when cuDNN will time this call's engines. The key is
    what cuDNN is handed: input shape (after ``Conv``'s own padding where
    low and high differ), weight shape, stride, padding, dtype."""
    x = args[0]
    shape, pads = list(x.shape), conv.pads(x.shape[2:])
    if any(lo != hi for lo, hi in pads):
        shape[2:] = [n + lo + hi for n, (lo, hi) in zip(shape[2:], pads)]
        pads = [(0, 0)] * len(pads)
    key = (tuple(shape), tuple(conv.weight.shape), conv.stride, tuple(pads), x.dtype)
    if key not in _CONV_KEYS:
        _CONV_KEYS.add(key)
        if torch.backends.cudnn.benchmark:
            count("map.conv_tuned", 1)


@dataclasses.dataclass(frozen=True)
class StreamMapNetConfig:
    """The JAX ``StreamMapNet``'s fields, with its defaults."""

    bev_hw: Tuple[int, int] = (25, 50)
    roi_size: Tuple[float, float] = (60.0, 30.0)
    img_size: Tuple[int, int] = (32, 64)
    embed_dim: int = 64
    num_queries: int = 50
    num_points: int = 20
    num_classes: int = 3
    streaming_bev: bool = True
    prior_pc_range: Optional[Sequence[float]] = None
    prior_voxel_size: Optional[Sequence[float]] = None
    prior_voxel_channels: int = 68
    use_prior_only: bool = False
    topk_propagate: int = 10
    num_levels: int = 1
    num_z_anchors: int = 1
    backbone: str = "simple"
    dcn: bool = False
    enc_layers: int = 2
    sca_capacity_frac: float = 1.0
    dec_layers: int = 2
    num_heads: int = 4
    tsa_prev: bool = False


class StreamMapNet(nn.Module):
    """One sample a call (a camera rig's frame). Submodules: ``backbone``
    (BEVEncoder), ``stream_fusion`` (ConvGRU, with ``streaming_bev``),
    ``prior_fusion`` (PriorFusion2D, with a prior range), ``head``."""

    def __init__(self, cfg: StreamMapNetConfig, device=None):
        super().__init__()
        if cfg.tsa_prev or cfg.use_prior_only:
            raise ValueError("tsa_prev and use_prior_only are not ported: no named config "
                             "sets them")
        self.cfg = cfg
        D = cfg.embed_dim
        self.backbone = BEVEncoder(
            bev_hw=cfg.bev_hw, roi_size=cfg.roi_size, img_size=cfg.img_size, embed_dim=D,
            num_levels=cfg.num_levels, num_z_anchors=cfg.num_z_anchors, backbone=cfg.backbone,
            dcn=cfg.dcn, num_layers=cfg.enc_layers, num_heads=cfg.num_heads,
            sca_capacity_frac=cfg.sca_capacity_frac, device=device)
        if cfg.streaming_bev:
            self.stream_fusion = ConvGRU(D, device)
        if cfg.prior_pc_range is not None:
            self.prior_fusion = PriorFusion2D(cfg.prior_pc_range, cfg.prior_voxel_size, D,
                                              cfg.prior_voxel_channels, hidden_channels=D,
                                              device=device)
        self.head = MapDetectorHead(
            cfg.bev_hw, num_queries=cfg.num_queries, num_classes=cfg.num_classes,
            num_points=cfg.num_points, embed_dim=D, num_layers=cfg.dec_layers,
            num_heads=cfg.num_heads, roi_size=cfg.roi_size, device=device)
        for conv in self.modules():
            if isinstance(conv, Conv):
                conv.register_forward_pre_hook(_count_tuned)

    def forward(self, imgs, lidar2img, prev_bev=None, prev2curr=None, prev_queries=None,
                prior_feats=None, prior_coords=None, prior_valid=None, prev_ref_pts=None,
                plain: bool = False) -> Dict[str, torch.Tensor]:
        """imgs (N_cam, 3, H, W); lidar2img (N_cam, 4, 4); prev_bev (C, Hb,
        Wb) and prev2curr (3, 3) the streaming memory and the 2D ego motion;
        prev_queries (k, D) and prev_ref_pts (k, P, 2) the last frame's
        hand-off; prior_feats (V, 68), prior_coords (V, 3), prior_valid (V,)
        the voxelized priors (None: no prior fusion); plain: S3's plain
        versions on the card (the kernels' check). Returns scores, lines,
        queries, ref_pts (keep when streaming: the current queries the
        decoder kept), bev, and the next frame's hand-off prop_queries and
        prop_ref_pts (rows prop_index of queries and ref_pts)."""
        cfg = self.cfg
        with span("map.forward"), ieee_convolutions(), tuned_convolutions(), ieee_matmul():
            bev = self.backbone(imgs, lidar2img, plain)
            if prev_bev is not None and cfg.streaming_bev:
                with span("map.stream"):
                    bev = self.stream_fusion(warp_bev(prev_bev, prev2curr, cfg.roi_size), bev)
            if prior_feats is not None:
                with span("map.prior_fusion"):
                    bev = self.prior_fusion(bev[None], prior_feats[None], prior_coords[None],
                                            prior_valid[None])[0]
            pose = None
            if prev_queries is not None:
                # the 2D ego motion lifted to the (4, 4) pose the head moves refs with
                pose = torch.eye(4, device=bev.device)
                pose[:2, :2] = prev2curr[:2, :2]
                pose[:2, 3] = prev2curr[:2, 2]
            with span("map.head"):
                out = self.head(bev, prev_queries, prev_ref_pts, pose, plain)
            out["bev"] = bev
            with span("map.propagate"):
                out["prop_index"], out["prop_queries"], out["prop_ref_pts"] = (
                    select_topk_for_propagation(out, cfg.topk_propagate))
            if profiling():
                self._count_sca(imgs.shape[0])
        return out

    def _count_sca(self, cameras: int) -> None:
        """The SCA counters: one read of each layer's per-camera counts from
        the card, so only inside a profiler session (an untraced forward
        never waits for the card)."""
        for core in self.backbone.sca_cores():
            n_valid = core.n_valid.tolist()
            K = core.capacity(self.cfg.bev_hw[0] * self.cfg.bev_hw[1])
            count("map.sca_pairs", sum(n_valid))
            count("map.sca_slots", cameras * K)
            count("map.sca_overflow", sum(max(v - K, 0) for v in n_valid))
