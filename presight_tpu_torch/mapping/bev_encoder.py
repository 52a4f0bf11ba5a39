"""BEVFormer encoder of the online-mapping model, the port of
presight_tpu/mapping/bev_encoder.py over NCHW tensors (reference: the smn
config smn_wcamprior_480_100x50_24e_randomdrop.py:85-142):

* image encoder: ResNet-50 (occupancy/backbones.ResNet, stages 1-3) with
  one full-width DCNv2 (:class:`DeformConv2d`) on each of the last two stage
  outputs, and an FPN (1x1 laterals, nearest top-down sum, 3x3 outputs) at
  ``embed_dim``; or the strided-conv stand-in of the ``*-toy`` config;
* encoder layer: :class:`TemporalSelfAttention` -> LayerNorm ->
  :class:`SpatialCrossAttention` (multi-level deformable attention around
  the z-anchor projections of each BEV pillar, queries compacted to each
  camera's frustum) -> LayerNorm -> FFN -> LayerNorm;
* learned row / column positional encoding of the BEV queries.

Every deformable tap goes through kernel S3 (mapping/deformable.py).
Submodules carry flax's auto-names, so ``bridge.map_state_from_flax`` maps
a flax tree onto the state_dict by path. LayerNorm is flax's (conv_gru.py).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import BatchNorm, Conv, Dense
from ..occupancy.backbones import ResNet, resnet_channels
from ..utils.profiler import span
from .conv_gru import LayerNorm
from .deformable import deform_im2col, level_rows, msda


class DeformConv2d(nn.Module):
    """DCNv2 (modulated deformable convolution, deform_groups 1): a conv
    (``offset_mask``) predicts each output pixel's k*k (dy, dx) offsets and
    mask logits; S3 builds the columns at p + p_k + dp_k, scaled by the
    sigmoid mask; ``cols @ kernel_w + kernel_b`` (flax's (k*k*C, F) layout,
    tap-major) is the convolution."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 1,
                 device=None):
        super().__init__()
        self.k, self.stride = kernel, stride
        self.offset_mask = Conv(in_channels, 3 * kernel * kernel, (kernel, kernel), stride,
                                device=device)
        self.kernel_w = nn.Parameter(torch.empty((kernel * kernel * in_channels, features),
                                                 device=device))
        self.kernel_b = nn.Parameter(torch.empty(features, device=device))

    def forward(self, x):
        B = x.shape[0]
        kk = self.k * self.k
        off = self.offset_mask(x).permute(0, 2, 3, 1)  # (B, Ho, Wo, 3 k*k)
        Ho, Wo = off.shape[1:3]
        # laid out for the kernel here, so the span holds its launch alone
        offsets = off[..., :2 * kk].reshape(B, Ho, Wo, kk, 2).contiguous()
        mask = torch.sigmoid(off[..., 2 * kk:]).contiguous()
        x_nhwc = x.permute(0, 2, 3, 1).contiguous()
        with span("map.dcn_im2col"):
            cols = deform_im2col(x_nhwc, offsets, mask, self.k, self.stride)
        out = torch.addmm(self.kernel_b, cols, self.kernel_w)
        return out.reshape(B, Ho, Wo, -1).permute(0, 3, 1, 2).contiguous()


class TemporalSelfAttention(nn.Module):
    """Deformable self-attention over a 2-frame BEV queue
    (temporal_self_attention.py:25-250) as StreamMapNet runs it, with no
    previous BEV: the queue holds the current queries twice, so offsets and
    weights come from concat([query, query]) and one value table serves
    both queues; each head samples ``num_points`` taps around its own cell
    in each; the two queues' outputs average. (The JAX package's
    ``prev_bev`` queue, for ``tsa_prev``, is not ported.)"""

    def __init__(self, embed_dim: int, bev_hw: Tuple[int, int], num_heads: int = 4,
                 num_points: int = 4, device=None):
        super().__init__()
        self.bev_hw, self.heads, self.points = tuple(bev_hw), num_heads, num_points
        D = embed_dim
        self.sampling_offsets = Dense(2 * D, num_heads * 2 * num_points * 2, device)
        self.attention_weights = Dense(2 * D, num_heads * 2 * num_points, device)
        self.value_proj = Dense(D, D, device)
        self.output_proj = Dense(D, D, device)
        H, W = bev_hw
        gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                                torch.arange(W, dtype=torch.float32), indexing="ij")
        # each query's own cell in pixel coordinates (x, y)
        self.register_buffer("ref", torch.stack([gx.reshape(-1), gy.reshape(-1)], -1).to(device),
                             persistent=False)

    def forward(self, query):
        Q, D = query.shape
        H, W = self.bev_hw
        Hh, P = self.heads, self.points
        q_aug = torch.cat([query, query], -1)
        offsets = self.sampling_offsets(q_aug).reshape(Q, Hh, 2, P, 2)
        attn = torch.softmax(self.attention_weights(q_aug).reshape(Q, Hh, 2, P), -1)
        value = self.value_proj(query)
        loc = self.ref[:, None, None, None, :] + offsets  # (Q, Hh, 2 queues, P, 2)
        with span("map.msda"):
            out = msda(value[None], [(H, W, 0), (H, W, 0)], loc[None], attn[None])[0]
        return self.output_proj(out * 0.5)


class FusedDeformableCore(nn.Module):
    """MSDeformableAttention3D of every camera at once (the JAX package's
    ``_FusedDeformableCore``): offsets and weights from the queries, one
    softmax over levels x points, the ``num_points`` taps of a (head, level)
    split over the z anchors, a tap weighing 0 where its anchor is outside
    the camera. Each camera's queries are compacted to its frustum: the
    first ``ceil(Q * capacity_frac)`` queries with an anchor inside, in
    index order (a stable sort), the rest of the slots padding of weight 0;
    a query past the capacity loses that camera's contribution and its
    count. Returns (the cameras' sum (Q, D), the count of cameras each query
    took (Q,)); ``n_valid`` keeps the last call's in-frustum queries per
    camera for the caller's counters."""

    def __init__(self, embed_dim: int, num_heads: int = 4, num_points: int = 8,
                 num_levels: int = 1, capacity_frac: float = 1.0, device=None):
        super().__init__()
        D = embed_dim
        self.heads, self.points, self.levels, self.capacity_frac = (
            num_heads, num_points, num_levels, capacity_frac)
        self.sampling_offsets = Dense(D, num_heads * num_levels * num_points * 2, device)
        self.attention_weights = Dense(D, num_heads * num_levels * num_points, device)
        for l in range(num_levels):
            self.add_module(f"value_proj_l{l}", Dense(D, D, device))
        # level l's pixels per level-0 pixel, made here so a forward copies
        # nothing from the host
        self.register_buffer("level_scale", torch.tensor([2.0 ** -l for l in range(num_levels)],
                                                         device=device), persistent=False)
        self.n_valid: Optional[torch.Tensor] = None

    def capacity(self, Q: int) -> int:
        return min(Q, int(math.ceil(Q * self.capacity_frac)))

    def forward(self, queries, ref_pix, cam_feats: Sequence[torch.Tensor], ref_valid):
        """queries (Q, D); ref_pix (N, A, Q, 2) level-0 feature pixels;
        cam_feats L maps (N, C, Hl, Wl), level l at 1/2^l of level 0;
        ref_valid (N, A, Q)."""
        Q, D = queries.shape
        N, A = ref_pix.shape[:2]
        L, Hh, P = self.levels, self.heads, self.points
        if P % A:
            raise ValueError(f"num_points ({P}) must be divisible by the anchor count ({A})")
        Pa = P // A
        offsets = self.sampling_offsets(queries).reshape(Q, Hh, L, Pa, A, 2)
        attn = torch.softmax(self.attention_weights(queries).reshape(Q, Hh, L * P), -1)
        attn = attn.reshape(Q, Hh, L, Pa, A)
        value = torch.cat([getattr(self, f"value_proj_l{l}")(f.permute(0, 2, 3, 1).reshape(
            N, -1, f.shape[1])) for l, f in enumerate(cam_feats)], 1)  # (N, R, D)
        levels = level_rows([f.shape[2:] for f in cam_feats])

        anyvalid = ref_valid.any(1)  # (N, Q)
        K = self.capacity(Q)
        qsel = torch.argsort((~anyvalid).to(torch.uint8), dim=1, stable=True)[:, :K]  # (N, K)
        slot_ok = torch.gather(anyvalid, 1, qsel).to(queries.dtype)
        valid = torch.gather(ref_valid.permute(0, 2, 1), 1,
                             qsel[..., None].expand(-1, -1, A)).to(queries.dtype)  # (N, K, A)
        ref = torch.gather(ref_pix.permute(0, 2, 1, 3), 1,
                           qsel[..., None, None].expand(-1, -1, A, 2))  # (N, K, A, 2)
        loc = (ref[:, :, None, None, None] * self.level_scale[:, None, None, None]
               + offsets[qsel])  # (N, K, Hh, L, Pa, A, 2)
        w = attn[qsel] * valid[:, :, None, None, None, :] * slot_ok[:, :, None, None, None, None]
        with span("map.msda"):
            out = msda(value, levels, loc.reshape(N, K, Hh, L, Pa * A, 2),
                       w.reshape(N, K, Hh, L, Pa * A))  # (N, K, D)
        rows = (qsel + Q * torch.arange(N, device=qsel.device)[:, None]).reshape(-1)
        total = out.new_zeros((N * Q, D)).index_copy_(0, rows, out.reshape(N * K, D))
        contrib = out.new_zeros(N * Q).index_copy_(0, rows, slot_ok.reshape(-1))
        self.n_valid = anyvalid.sum(1)
        return total.reshape(N, Q, D).sum(0), contrib.reshape(N, Q).sum(0)


class SpatialCrossAttention(nn.Module):
    """Camera aggregation (spatial_cross_attention.py:30-200): the cameras'
    deformable outputs summed, over the count of cameras each query took,
    then projected."""

    def __init__(self, embed_dim: int, num_heads: int = 4, num_points: int = 8,
                 num_levels: int = 1, capacity_frac: float = 1.0, device=None):
        super().__init__()
        self.deformable_attention = FusedDeformableCore(embed_dim, num_heads, num_points,
                                                        num_levels, capacity_frac, device)
        self.output_proj = Dense(embed_dim, embed_dim, device)

    def forward(self, queries, ref_pix, cam_feats, ref_valid):
        out, hits = self.deformable_attention(queries, ref_pix, cam_feats, ref_valid)
        return self.output_proj(out / torch.clamp_min(hits, 1.0)[:, None])


class EncoderLayer(nn.Module):
    """BEVFormerLayer: self_attn -> norm -> cross_attn -> norm -> ffn -> norm
    (config :127-135)."""

    def __init__(self, embed_dim: int, bev_hw: Tuple[int, int], num_heads: int = 4,
                 num_points: int = 4, num_levels: int = 1, cross_num_points: int = 8,
                 sca_capacity_frac: float = 1.0, device=None):
        super().__init__()
        D = embed_dim
        self.temporal_self_attn = TemporalSelfAttention(D, bev_hw, num_heads, num_points, device)
        self.LayerNorm_0 = LayerNorm(D, device)
        self.spatial_cross_attn = SpatialCrossAttention(D, num_heads, cross_num_points,
                                                        num_levels, sca_capacity_frac, device)
        self.LayerNorm_1 = LayerNorm(D, device)
        self.Dense_0 = Dense(D, 2 * D, device)
        self.Dense_1 = Dense(2 * D, D, device)
        self.LayerNorm_2 = LayerNorm(D, device)

    def forward(self, bev_q, ref_pix, cam_feats, ref_valid):
        bev_q = self.LayerNorm_0(bev_q + self.temporal_self_attn(bev_q))
        bev_q = self.LayerNorm_1(bev_q + self.spatial_cross_attn(bev_q, ref_pix, cam_feats,
                                                                 ref_valid))
        return self.LayerNorm_2(bev_q + self.Dense_1(F.relu(self.Dense_0(bev_q))))


def bev_pillars(bev_hw: Tuple[int, int], roi_size: Tuple[float, float],
                z_anchors: Sequence[float]) -> torch.Tensor:
    """Homogeneous ego points (A, Q, 4) of each BEV cell's centre at each
    z anchor (float64 in numpy, then float32, as the JAX package makes
    them)."""
    H, W = bev_hw
    rw, rh = roi_size
    xs = (np.arange(W) + 0.5) / W * rw - rw / 2
    ys = (np.arange(H) + 0.5) / H * rh - rh / 2
    gx, gy = np.meshgrid(xs, ys)
    pts = [np.stack([gx, gy, np.full_like(gx, z), np.ones_like(gx)], -1).reshape(-1, 4)
           for z in z_anchors]
    return torch.as_tensor(np.stack(pts), dtype=torch.float32)


def project_bev_to_cameras(pillars: torch.Tensor, lidar2img: torch.Tensor,
                           img_size: Tuple[int, int], feat_size: Tuple[int, int]):
    """Pillar points (A, Q, 4) projected into each camera: (level-0 feature
    pixel coordinates (N, A, Q, 2), in-image (N, A, Q)) (encoder.py
    point_sampling)."""
    cam = torch.einsum("nij,aqj->naqi", lidar2img, pillars)
    eps = 1e-5
    depth = cam[..., 2]
    px = cam[..., 0] / torch.clamp_min(depth, eps)
    py = cam[..., 1] / torch.clamp_min(depth, eps)
    h_img, w_img = img_size
    hf, wf = feat_size
    valid = (depth > eps) & (px >= 0) & (px < w_img) & (py >= 0) & (py < h_img)
    return torch.stack([px * wf / w_img, py * hf / h_img], -1), valid


class BEVEncoder(nn.Module):
    """images -> multi-scale camera features -> ``num_layers`` BEVFormer
    layers -> BEV (embed_dim, H, W)."""

    def __init__(self, bev_hw: Tuple[int, int], roi_size: Tuple[float, float],
                 img_size: Tuple[int, int], embed_dim: int = 64, num_layers: int = 2,
                 num_heads: int = 4, num_points: int = 4, cross_num_points: int = 8,
                 num_levels: int = 1, num_z_anchors: int = 1,
                 z_range: Tuple[float, float] = (-3.0, 3.0),
                 backbone_widths: Sequence[int] = (16, 32, 64), backbone: str = "simple",
                 resnet_depth: int = 50, resnet_base_width: int = 64, dcn: bool = False,
                 sca_capacity_frac: float = 1.0, device=None):
        super().__init__()
        self.bev_hw, self.img_size = tuple(bev_hw), tuple(img_size)
        self.embed_dim, self.num_levels, self.backbone = embed_dim, num_levels, backbone
        self.dcn, self.num_layers = dcn, num_layers
        D = embed_dim
        if backbone == "resnet":
            self.resnet = ResNet(resnet_depth, (1, 2, 3), resnet_base_width, device=device)
            chans = resnet_channels(resnet_depth, resnet_base_width)[1:]
            if dcn:
                self.dcn_s3 = DeformConv2d(chans[1], chans[1], device=device)
                self.dcn_s4 = DeformConv2d(chans[2], chans[2], device=device)
            for i, c in enumerate(chans):
                self.add_module(f"fpn_lat{i}", Conv(c, D, (1, 1), device=device))
            for i in range(num_levels):
                self.add_module(f"fpn_out{i}", Conv(D, D, (3, 3), device=device))
        else:
            self.necks: List[int] = []
            c = 3
            for i, w in enumerate(backbone_widths):
                self.add_module(f"Conv_{i}", Conv(c, w, (3, 3), 2, device=device))
                self.add_module(f"BatchNorm_{i}", BatchNorm(w, device))
                if len(backbone_widths) - i <= num_levels:
                    self.add_module(f"neck{i}", Conv(w, D, (1, 1), device=device))
                    self.necks.append(i)
                c = w
            self.widths = tuple(backbone_widths)
        H, W = bev_hw
        self.bev_queries = nn.Parameter(torch.empty((H * W, D), device=device))
        self.pos_row = nn.Parameter(torch.empty((H, D // 2), device=device))
        self.pos_col = nn.Parameter(torch.empty((W, D // 2), device=device))
        zs = np.linspace(z_range[0], z_range[1], num_z_anchors) if num_z_anchors > 1 else [0.0]
        self.register_buffer("pillars", bev_pillars(bev_hw, roi_size, tuple(zs)).to(device),
                             persistent=False)
        for i in range(num_layers):
            self.add_module(f"layer{i}", EncoderLayer(D, bev_hw, num_heads, num_points,
                                                      num_levels, cross_num_points,
                                                      sca_capacity_frac, device))

    def image_features(self, imgs) -> List[torch.Tensor]:
        """(N, 3, H, W) -> ``num_levels`` maps (N, embed_dim, Hl, Wl)."""
        if self.backbone == "resnet":
            feats = self.resnet(imgs)
            if self.dcn:
                feats[1] = self.dcn_s3(feats[1])
                feats[2] = self.dcn_s4(feats[2])
            lat = [getattr(self, f"fpn_lat{i}")(f) for i, f in enumerate(feats)]
            for i in range(len(lat) - 1, 0, -1):
                # jax.image.resize "nearest": source index floor((i + 0.5) * in / out)
                lat[i - 1] = lat[i - 1] + F.interpolate(lat[i], size=lat[i - 1].shape[2:],
                                                        mode="nearest-exact")
            return [getattr(self, f"fpn_out{i}")(lat[i]) for i in range(self.num_levels)]
        levels, x = [], imgs
        for i in range(len(self.widths)):
            x = F.relu(getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(x)))
            if i in self.necks:
                levels.append(getattr(self, f"neck{i}")(x))
        return levels[:self.num_levels]

    def forward(self, imgs, lidar2img):
        """imgs (N, 3, H, W); lidar2img (N, 4, 4). The temporal
        self-attention runs over [query, query], as StreamMapNet runs it."""
        with span("map.image_encoder"):
            levels = self.image_features(imgs)
        with span("map.bev_encoder"):
            H, W = self.bev_hw
            D = self.embed_dim
            pos = torch.cat([self.pos_row[:, None, :].expand(H, W, D // 2),
                             self.pos_col[None, :, :].expand(H, W, D // 2)], -1)
            h = self.bev_queries + pos.reshape(H * W, D)
            ref_pix, valid = project_bev_to_cameras(self.pillars, lidar2img, self.img_size,
                                                    levels[0].shape[2:])
            for i in range(self.num_layers):
                h = getattr(self, f"layer{i}")(h, ref_pix, levels, valid)
            return h.reshape(H, W, D).permute(2, 0, 1)

    def sca_cores(self) -> List[FusedDeformableCore]:
        return [getattr(self, f"layer{i}").spatial_cross_attn.deformable_attention
                for i in range(self.num_layers)]
