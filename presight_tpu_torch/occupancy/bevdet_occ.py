"""BEVDet-Occ and its loss, the port of presight_tpu/occupancy/
bevdet_occ.py (BEVStereo4DOCC: image encoder, LSS view transformer with the
temporal stereo cost volume, temporal BEV align, voxel prior fusion, BEV
encoder, occupancy head).

The model is built from a :class:`BEVDetOccConfig` (the flax module's
fields) on an explicit device, with empty parameters: ``init_weights``
(models/layers.py) fills them from a generator, ``bridge.occ_state_from_flax``
from a JAX checkpoint. It serves in eval mode (BatchNorm on its running
statistics) and trains in train mode (``model.train()``: BatchNorm on the
batch's statistics, updating the running ones as flax does) under
:func:`occ_loss`. Convolutions run in IEEE f32 (``utils.precision.ieee_convolutions``, the
process's setting restored after each forward).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..mapping.conv_gru import warp_bev
from ..models.prior_fusion import PriorFusion3DVoxel
from ..utils.precision import ieee_convolutions
from ..utils.profiler import span
from .backbones import CustomFPN, CustomResNet3D, LSSFPN3D, ResNet, resnet_channels
from ..models.layers import BatchNorm, Conv, Dense
from .view_transformer import LSSViewTransformer


@dataclasses.dataclass(frozen=True)
class BEVDetOccConfig:
    """The fields of the JAX package's BEVDetOcc (bevdet_occ.py:119-164)."""

    grid_config: Dict[str, Tuple[float, float, float]]
    input_size: Tuple[int, int]
    downsample: int = 16
    view_out_channels: int = 64
    img_widths: Sequence[int] = (32, 64, 128, 256)
    neck_channels: int = 256
    backbone: str = "simple"
    """'simple' (strided-conv stand-in) or 'resnet' (ResNet out_indices
    (0, 2, 3) + CustomFPN, the reference topology)."""
    resnet_depth: int = 50
    resnet_base_width: int = 64
    bev_neck: str = "simple"
    """'simple' (BEVEncoder3D) or 'lssfpn3d' (CustomResNet3D + LSSFPN3D)."""
    bev_widths: Sequence[int] = (64, 128)
    bev_out_channels: int = 32
    occ_out_dim: int = 32
    num_classes: int = 18
    prior_pc_range: Optional[Sequence[float]] = None
    prior_voxel_size: Optional[Sequence[float]] = None
    prior_in_channels: int = 68
    prior_fusion: str = "voxel"
    """'voxel' (PriorFusion3D_voxel); 'crossattn' is not ported yet."""
    use_prior_only: bool = False
    temporal: bool = False
    stereo: bool = False
    stereo_stage: int = 2

    def grid_size(self) -> Tuple[int, int, int]:
        """(X, Y, Z) voxel counts."""
        g = self.grid_config
        return tuple(int(round((g[k][1] - g[k][0]) / g[k][2])) for k in ("x", "y", "z"))


class ConvStage(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int = 1, device=None):
        super().__init__()
        self.Conv_0 = Conv(in_channels, features, (3, 3), stride, device=device)
        self.BatchNorm_0 = BatchNorm(features, device)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class ImageEncoder(nn.Module):
    """Strided conv backbone + 1x1 neck (the toy stand-in for ResNet +
    CustomFPN); stage ``stereo_stage`` doubles as the stereo feature."""

    def __init__(self, widths: Sequence[int], neck_channels: int, stereo_stage: int = 2,
                 device=None):
        super().__init__()
        self.stereo_stage = stereo_stage
        ch = 3
        for i, w in enumerate(widths):
            self.add_module(f"ConvStage_{2 * i}", ConvStage(ch, w, 2, device))
            self.add_module(f"ConvStage_{2 * i + 1}", ConvStage(w, w, 1, device))
            ch = w
        self.num_stages = len(widths)
        self.Conv_0 = Conv(ch, neck_channels, (1, 1), device=device)

    def forward(self, imgs, return_stereo: bool = False):
        x, stereo = imgs, None
        for i in range(self.num_stages):
            x = getattr(self, f"ConvStage_{2 * i + 1}")(getattr(self, f"ConvStage_{2 * i}")(x))
            if i + 1 == self.stereo_stage:
                stereo = x
        out = self.Conv_0(x)
        return (out, stereo) if return_stereo else out


class BEVEncoder3D(nn.Module):
    """3x3x3 conv stack on the (B, C, Z, Y, X) volume (the toy stand-in for
    CustomResNet3D + LSSFPN3D)."""

    def __init__(self, in_channels: int, widths: Sequence[int], out_channels: int, device=None):
        super().__init__()
        ch = in_channels
        for i, w in enumerate(widths):
            self.add_module(f"Conv_{i}", Conv(ch, w, (3, 3, 3), device=device))
            self.add_module(f"BatchNorm_{i}", BatchNorm(w, device))
            ch = w
        self.num_layers = len(widths)
        self.add_module(f"Conv_{len(widths)}", Conv(ch, out_channels, (3, 3, 3), device=device))

    def forward(self, x):
        for i in range(self.num_layers):
            x = F.relu(getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(x)))
        return getattr(self, f"Conv_{self.num_layers}")(x)


class OccHead(nn.Module):
    """Final 3D conv + softplus predicter (bevdet_occ.py:27-42 of the
    reference): (B, C, Z, Y, X) -> (B, X, Y, Z, num_classes) logits."""

    def __init__(self, in_channels: int, out_dim: int = 32, num_classes: int = 18,
                 use_predicter: bool = True, device=None):
        super().__init__()
        self.use_predicter = use_predicter
        self.Conv_0 = Conv(in_channels, out_dim if use_predicter else num_classes, (3, 3, 3),
                           device=device)
        if use_predicter:
            self.Dense_0 = Dense(out_dim, out_dim * 2, device)
            self.Dense_1 = Dense(out_dim * 2, num_classes, device)

    def forward(self, x):
        h = self.Conv_0(x).permute(0, 4, 3, 2, 1)
        if self.use_predicter:
            h = self.Dense_1(F.softplus(self.Dense_0(h)))
        return h


class BEVDetOcc(nn.Module):
    """BEVDet-Occ with the PreSight prior-fusion hook. Built in eval mode;
    ``model.train()`` trains it.

    ``forward`` takes the JAX module's inputs: imgs (B, N, 3, H, W) and the
    per-camera geometry, the voxelized priors (``prior_feats`` (B, V, 68),
    ``prior_coords`` (B, V, 3), ``prior_valid`` (B, V)), and the previous
    frame's ``prev_bev`` (B, C, Z, Y, X) with ``prev2curr`` (B, 3, 3) and
    ``prev_stereo_feat`` (B, N, Hs, Ws, Cs) with ``k2s_sensor``
    (B, N, 4, 4). It returns (occ logits (B, X, Y, Z, classes), depth
    (B*N, D, Hf, Wf)) and, with stereo, the current stereo features
    (B, N, Hs, Ws, Cs) for the next frame.

    Its parameters live on ``device``, the card unless the caller names
    another. The prior fusion exists when ``with_prior_fusion`` (by default: when
    the config has a prior range), as the JAX module's parameters exist
    only when priors were traced at init.
    """

    def __init__(self, config: BEVDetOccConfig, device=None,
                 with_prior_fusion: Optional[bool] = None):
        super().__init__()
        device = torch.device("cuda" if device is None else device)
        cfg = self.config = config
        C = cfg.view_out_channels
        if cfg.backbone == "resnet":
            chans = resnet_channels(cfg.resnet_depth, cfg.resnet_base_width)
            self.ResNet_0 = ResNet(cfg.resnet_depth, (0, 2, 3), cfg.resnet_base_width,
                                   device=device)
            self.CustomFPN_0 = CustomFPN(chans[2:], cfg.neck_channels, (0,), device)
            cv_downsample = 4
        elif cfg.backbone == "simple":
            self.ImageEncoder_0 = ImageEncoder(cfg.img_widths, cfg.neck_channels,
                                               cfg.stereo_stage, device)
            cv_downsample = 2 ** cfg.stereo_stage
        else:
            raise ValueError(f"unknown backbone {cfg.backbone!r}")
        self.LSSViewTransformer_0 = LSSViewTransformer(
            cfg.grid_config, cfg.input_size, cfg.downsample, cfg.neck_channels, C,
            collapse_z=False, stereo=cfg.stereo, cv_downsample=cv_downsample, device=device)
        if cfg.temporal:
            self.temporal_fuse = Conv(2 * C, C, (1, 1, 1), device=device)
        self.with_prior_fusion = (cfg.prior_pc_range is not None if with_prior_fusion is None
                                  else with_prior_fusion)
        gx, gy, gz = cfg.grid_size()
        if self.with_prior_fusion:
            if cfg.prior_fusion != "voxel":
                raise NotImplementedError(
                    f"prior_fusion={cfg.prior_fusion!r} needs models/window_attention.py, "
                    "which is not ported yet (ROADMAP Queue 1 item 4(c))")
            self.PriorFusion3DVoxel_0 = PriorFusion3DVoxel(
                cfg.prior_pc_range, cfg.prior_voxel_size, bev_channels=C, out_num_z=gz,
                out_channels=C, bev_hidden_channels=cfg.neck_channels,
                prior_in_channels=cfg.prior_in_channels, device=device)
        if cfg.bev_neck == "lssfpn3d":
            self.CustomResNet3D_0 = CustomResNet3D(C, (1, 2, 4), (C, 2 * C, 4 * C), (1, 2, 2),
                                                   device=device)
            self.LSSFPN3D_0 = LSSFPN3D(7 * C, C, device)
            head_in = C
        elif cfg.bev_neck == "simple":
            self.BEVEncoder3D_0 = BEVEncoder3D(C, cfg.bev_widths, cfg.bev_out_channels, device)
            head_in = cfg.bev_out_channels
        else:
            raise ValueError(f"unknown bev_neck {cfg.bev_neck!r}")
        self.OccHead_0 = OccHead(head_in, cfg.occ_out_dim, cfg.num_classes, device=device)
        self.eval()

    def forward(self, imgs, sensor2ego, cam2imgs, post_rots, post_trans, bda,
                prior_feats=None, prior_coords=None, prior_valid=None,
                prev_bev=None, prev2curr=None, prev_stereo_feat=None, k2s_sensor=None):
        with span("occ.forward"), ieee_convolutions():
            return self._forward(imgs, sensor2ego, cam2imgs, post_rots, post_trans, bda,
                                 prior_feats, prior_coords, prior_valid, prev_bev, prev2curr,
                                 prev_stereo_feat, k2s_sensor)

    def _forward(self, imgs, sensor2ego, cam2imgs, post_rots, post_trans, bda, prior_feats,
                 prior_coords, prior_valid, prev_bev, prev2curr, prev_stereo_feat, k2s_sensor):
        cfg = self.config
        B, N, _, H, W = imgs.shape
        with span("occ.image_encoder"):
            x = imgs.reshape(B * N, 3, H, W)
            curr_stereo = None
            if cfg.backbone == "resnet":
                feats = self.ResNet_0(x)
                curr_stereo = feats[0] if cfg.stereo else None
                x = self.CustomFPN_0(feats[1:])
            elif cfg.stereo:
                x, curr_stereo = self.ImageEncoder_0(x, return_stereo=True)
            else:
                x = self.ImageEncoder_0(x)
            x = x.reshape(B, N, *x.shape[1:])
            stereo_metas = None
            if cfg.stereo:
                # (BN, Cs, Hs, Ws) -> (B, N, Hs, Ws, Cs): S2 gathers whole channel rows
                curr_stereo = curr_stereo.permute(0, 2, 3, 1).reshape(
                    B, N, *curr_stereo.shape[2:], curr_stereo.shape[1]).contiguous()
                stereo_metas = dict(curr_feat=curr_stereo, prev_feat=prev_stereo_feat,
                                    k2s_sensor=k2s_sensor)
        with span("occ.view_transformer"):
            bev, depth = self.LSSViewTransformer_0(x, sensor2ego, cam2imgs, post_rots,
                                                   post_trans, bda, stereo_metas)
        with span("occ.bev_encoder"):
            if cfg.temporal:
                # BEVDet4D: warp each z slice of the previous volume into the
                # current ego frame, concatenate, fuse back with a 1x1x1 conv.
                if prev_bev is None:
                    prev_bev = torch.zeros_like(bev)
                if prev2curr is None:
                    prev2curr = torch.eye(3, device=bev.device).expand(B, 3, 3)
                gx, gy = cfg.grid_config["x"], cfg.grid_config["y"]
                roi = (gx[1] - gx[0], gy[1] - gy[0])
                _, c, z, yy, xx = prev_bev.shape
                aligned = torch.stack([
                    warp_bev(prev_bev[b].reshape(c * z, yy, xx), prev2curr[b], roi)
                    for b in range(B)]).reshape(prev_bev.shape)
                bev = self.temporal_fuse(torch.cat([bev, aligned], dim=1))
            if prior_feats is not None:
                v = bev.permute(0, 1, 3, 4, 2)  # (B, C, Y, X, Z)
                if cfg.use_prior_only:
                    v = torch.zeros_like(v)
                v = self.PriorFusion3DVoxel_0(v, prior_feats, prior_coords, prior_valid)
                bev = v.permute(0, 1, 4, 2, 3)
            if cfg.bev_neck == "lssfpn3d":
                bev = self.LSSFPN3D_0(self.CustomResNet3D_0(bev.contiguous()))
            else:
                bev = self.BEVEncoder3D_0(bev.contiguous())
            occ = self.OccHead_0(bev)
        if cfg.stereo:
            return occ, depth, curr_stereo
        return occ, depth


def occ_loss(logits: torch.Tensor, voxel_semantics: torch.Tensor,
             mask_camera: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Occupancy cross-entropy (bevdet_occ.py:286-301 of the JAX package):
    flat log-softmax CE of logits (B, X, Y, Z, classes) at the integer
    labels (B, X, Y, Z); with ``mask_camera`` (0/1) sum(ce * m) /
    max(sum(m), 1), else the mean."""
    num_classes = logits.shape[-1]
    logp = torch.log_softmax(logits.reshape(-1, num_classes), dim=-1)
    labels = voxel_semantics.reshape(-1).long()
    ce = -logp.gather(1, labels[:, None])[:, 0]
    if mask_camera is not None:
        m = mask_camera.reshape(-1).to(ce.dtype)
        return (ce * m).sum() / m.sum().clamp_min(1.0)
    return ce.mean()
