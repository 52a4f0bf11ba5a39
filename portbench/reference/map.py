"""Plain PyTorch reference of StreamMapNet with the city prior
(smn_wcamprior_480_100x50_24e_randomdrop) served frame by frame: a plain
reading of presight_tpu/mapping/ (bev_encoder.py, conv_gru.py, map_head.py,
stream_mapnet.py) and PriorFusion2D of presight_tpu/models/prior_fusion.py.

* Every bilinear tap is written out as four gathers of the map's rows
  (floor of the pixel coordinate, corner weights (1 - wy)(1 - wx), (1 - wy)
  wx, wy (1 - wx), wy wx, a corner outside the map weighing 0), per head
  and per point.
* The spatial cross-attention runs every camera over every BEV query,
  uncompacted, each anchor's taps masked where the anchor is outside the
  camera, and normalised by the number of cameras that see the query. The
  program compacts each camera's queries to its frustum at half the
  queries; where no camera overflows its capacity the two agree.
* DCNv2 builds its columns with the four gathers and multiplies them by
  ``kernel_w``, then adds ``kernel_b``.
* Convolutions and matrix products run in IEEE float32
  (``ieee_convolutions``; TF32 with ``ieee=False``, the control).

The layers, the ResNet, ``warp_bev`` and the prior's voxel grid are those of
``reference.occ``. Module names, and so the state_dict keys, are the
port's, so one state_dict feeds both. Imports nothing of the port.

Departures of the JAX package (and so of this reference and the port) from
the published StreamMapNet, kept here as it has them: one full-width DCNv2
after each of ResNet stages 3 and 4 (the source deforms every 3x3 conv of
those stages); the temporal self-attention over [query, query] (the
source's streaming memory is the ConvGRU); the spatial cross-attention's
compaction at half the queries (the program's; exact on this rig);
deformable taps at ``ref * W + offset`` (no half-pixel shift); the top-k
hand-off inside the served frame.

A top-k choice (the queries the decoder keeps, and the hand-off) is
discrete: where two scores differ by less than the rounding between two
implementations, the choice is rounding's. So a frame can follow a
program's choices (``keep``, ``prop_index``) and report, in
``order_gaps``, how far each is from the order of this reference's scores.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reference.occ import (BatchNorm, Conv, Dense, ResNet, VoxelFeatureExtractor, _ConvBNReLU,
                           _resize_bilinear, formulate_voxels, ieee_convolutions,
                           resnet_channels, voxel_resolution, warp_bev)

__all__ = ["StreamMapNetConfig", "StreamMapNet", "ieee_convolutions", "bilinear",
           "deform_columns", "select_topk_for_propagation"]


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm over the last axis (epsilon 1e-6)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))

    def forward(self, x):
        return F.layer_norm(x, self.weight.shape, self.weight, self.bias, 1e-6)


def bilinear(rows: torch.Tensor, px: torch.Tensor, py: torch.Tensor, H: int,
             W: int) -> torch.Tensor:
    """rows (H * W, C) of a map; px, py (...) pixel coordinates -> (..., C):
    four gathers, the corners outside the map weighing 0."""
    x0f, y0f = torch.floor(px), torch.floor(py)
    wx, wy = px - x0f, py - y0f
    x0, y0 = x0f.long(), y0f.long()
    out = 0
    for dy, dx, w in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                      (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        yy, xx = y0 + dy, x0 + dx
        inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        index = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).reshape(-1)
        corner = rows[index].reshape(*px.shape, rows.shape[-1])
        out = out + corner * (w * inside.to(w.dtype))[..., None]
    return out


def head_taps(value: torch.Tensor, heads: int, px: torch.Tensor, py: torch.Tensor, H: int,
              W: int) -> torch.Tensor:
    """value (H * W, D); px, py (Q, heads, P): head h sampled at its own
    points from its own channels -> (Q, heads, P, D / heads)."""
    hd = value.shape[1] // heads
    return torch.stack([bilinear(value[:, h * hd:(h + 1) * hd], px[:, h], py[:, h], H, W)
                        for h in range(heads)], 1)


def deform_columns(x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor, k: int,
                   stride: int = 1) -> torch.Tensor:
    """DCNv2's columns: x (B, H, W, C), offsets (B, Ho, Wo, k*k, 2) as (dy,
    dx), mask (B, Ho, Wo, k*k) -> (B * Ho * Wo, k*k * C), tap-major."""
    B, H, W, C = x.shape
    Ho, Wo = offsets.shape[1:3]
    ky, kx = np.meshgrid(np.arange(k) - k // 2, np.arange(k) - k // 2, indexing="ij")
    base = torch.tensor(np.stack([ky.reshape(-1), kx.reshape(-1)], -1), dtype=x.dtype,
                        device=x.device)
    gy = torch.arange(Ho, dtype=x.dtype, device=x.device)[:, None, None] * stride
    gx = torch.arange(Wo, dtype=x.dtype, device=x.device)[None, :, None] * stride
    py = gy + base[None, None, :, 0] + offsets[..., 0]
    px = gx + base[None, None, :, 1] + offsets[..., 1]
    cols = [bilinear(x[b].reshape(H * W, C), px[b], py[b], H, W) * mask[b][..., None]
            for b in range(B)]
    return torch.stack(cols).reshape(B * Ho * Wo, k * k * C)


class DeformConv2d(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel: int = 3, device=None):
        super().__init__()
        self.k = kernel
        self.offset_mask = Conv(in_channels, 3 * kernel * kernel, (kernel, kernel),
                                device=device)
        self.kernel_w = nn.Parameter(torch.empty((kernel * kernel * in_channels, features),
                                                 device=device))
        self.kernel_b = nn.Parameter(torch.empty(features, device=device))

    def forward(self, x):  # NCHW
        B = x.shape[0]
        kk = self.k * self.k
        off = self.offset_mask(x).permute(0, 2, 3, 1)
        Ho, Wo = off.shape[1:3]
        cols = deform_columns(x.permute(0, 2, 3, 1), off[..., :2 * kk].reshape(B, Ho, Wo, kk, 2),
                              torch.sigmoid(off[..., 2 * kk:]), self.k)
        out = cols @ self.kernel_w + self.kernel_b
        return out.reshape(B, Ho, Wo, -1).permute(0, 3, 1, 2)


class TemporalSelfAttention(nn.Module):
    def __init__(self, D: int, bev_hw, heads: int, points: int, device=None):
        super().__init__()
        self.bev_hw, self.heads, self.points = tuple(bev_hw), heads, points
        self.sampling_offsets = Dense(2 * D, heads * 2 * points * 2, device)
        self.attention_weights = Dense(2 * D, heads * 2 * points, device)
        self.value_proj = Dense(D, D, device)
        self.output_proj = Dense(D, D, device)

    def forward(self, query, prev_bev=None):
        Q, D = query.shape
        H, W = self.bev_hw
        Hh, P = self.heads, self.points
        if prev_bev is None:
            prev_bev = query
        q_aug = torch.cat([prev_bev, query], -1)
        offsets = self.sampling_offsets(q_aug).reshape(Q, Hh, 2, P, 2)
        attn = torch.softmax(self.attention_weights(q_aug).reshape(Q, Hh, 2, P), -1)
        gy, gx = torch.meshgrid(torch.arange(H, dtype=query.dtype, device=query.device),
                                torch.arange(W, dtype=query.dtype, device=query.device),
                                indexing="ij")
        ref = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
        outs = []
        for i, v in enumerate((prev_bev, query)):
            value = self.value_proj(v)
            px = ref[:, None, None, 0] + offsets[:, :, i, :, 0]
            py = ref[:, None, None, 1] + offsets[:, :, i, :, 1]
            taps = head_taps(value, Hh, px, py, H, W)  # (Q, Hh, P, hd)
            outs.append((taps * attn[:, :, i, :, None]).sum(2))
        out = ((outs[0] + outs[1]) / 2).reshape(Q, D)
        return self.output_proj(out)


class FusedDeformableCore(nn.Module):
    """Every camera over every query, uncompacted: each anchor's taps masked
    where the anchor is outside the camera."""

    def __init__(self, D: int, heads: int, points: int, levels: int, device=None):
        super().__init__()
        self.heads, self.points, self.levels = heads, points, levels
        self.sampling_offsets = Dense(D, heads * levels * points * 2, device)
        self.attention_weights = Dense(D, heads * levels * points, device)
        for l in range(levels):
            self.add_module(f"value_proj_l{l}", Dense(D, D, device))

    def forward(self, queries, ref_pix, cam_feats, ref_valid):
        Q, D = queries.shape
        N, A = ref_pix.shape[:2]
        L, Hh, P = self.levels, self.heads, self.points
        Pa = P // A
        offsets = self.sampling_offsets(queries).reshape(Q, Hh, L, Pa, A, 2)
        attn = torch.softmax(self.attention_weights(queries).reshape(Q, Hh, L * P), -1)
        attn = attn.reshape(Q, Hh, L, Pa, A)
        out = queries.new_zeros((Q, Hh, D // Hh))
        for n in range(N):
            for l, feat in enumerate(cam_feats):
                Hl, Wl = feat.shape[2:]
                value = getattr(self, f"value_proj_l{l}")(
                    feat[n].permute(1, 2, 0).reshape(Hl * Wl, -1))
                for a in range(A):
                    scale = 1.0 / 2 ** l
                    px = ref_pix[n, a, :, None, None, 0] * scale + offsets[:, :, l, :, a, 0]
                    py = ref_pix[n, a, :, None, None, 1] * scale + offsets[:, :, l, :, a, 1]
                    taps = head_taps(value, Hh, px, py, Hl, Wl)  # (Q, Hh, Pa, hd)
                    taps = taps * ref_valid[n, a].to(taps.dtype)[:, None, None, None]
                    out = out + (taps * attn[:, :, l, :, a, None]).sum(2)
        hits = ref_valid.any(1).to(queries.dtype).sum(0)
        return out.reshape(Q, D), hits


class SpatialCrossAttention(nn.Module):
    def __init__(self, D: int, heads: int, points: int, levels: int, device=None):
        super().__init__()
        self.deformable_attention = FusedDeformableCore(D, heads, points, levels, device)
        self.output_proj = Dense(D, D, device)

    def forward(self, queries, ref_pix, cam_feats, ref_valid):
        out, hits = self.deformable_attention(queries, ref_pix, cam_feats, ref_valid)
        return self.output_proj(out / torch.clamp_min(hits, 1.0)[:, None])


class EncoderLayer(nn.Module):
    def __init__(self, D: int, bev_hw, heads: int, points: int, levels: int,
                 cross_points: int, device=None):
        super().__init__()
        self.temporal_self_attn = TemporalSelfAttention(D, bev_hw, heads, points, device)
        self.LayerNorm_0 = LayerNorm(D, device)
        self.spatial_cross_attn = SpatialCrossAttention(D, heads, cross_points, levels, device)
        self.LayerNorm_1 = LayerNorm(D, device)
        self.Dense_0 = Dense(D, 2 * D, device)
        self.Dense_1 = Dense(2 * D, D, device)
        self.LayerNorm_2 = LayerNorm(D, device)

    def forward(self, q, ref_pix, feats, valid):
        q = self.LayerNorm_0(q + self.temporal_self_attn(q))
        q = self.LayerNorm_1(q + self.spatial_cross_attn(q, ref_pix, feats, valid))
        return self.LayerNorm_2(q + self.Dense_1(F.relu(self.Dense_0(q))))


def project_bev_to_cameras(bev_hw, roi_size, lidar2img, img_size, feat_size, z_anchors):
    H, W = bev_hw
    rw, rh = roi_size
    xs = (np.arange(W) + 0.5) / W * rw - rw / 2
    ys = (np.arange(H) + 0.5) / H * rh - rh / 2
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([np.stack([gx, gy, np.full_like(gx, z), np.ones_like(gx)], -1).reshape(-1, 4)
                    for z in z_anchors])
    pts = torch.tensor(pts, dtype=torch.float32, device=lidar2img.device)
    cam = torch.einsum("nij,aqj->naqi", lidar2img, pts)
    depth = cam[..., 2]
    px = cam[..., 0] / torch.clamp_min(depth, 1e-5)
    py = cam[..., 1] / torch.clamp_min(depth, 1e-5)
    h_img, w_img = img_size
    hf, wf = feat_size
    valid = (depth > 1e-5) & (px >= 0) & (px < w_img) & (py >= 0) & (py < h_img)
    return torch.stack([px * wf / w_img, py * hf / h_img], -1), valid


class BEVEncoder(nn.Module):
    def __init__(self, cfg: "StreamMapNetConfig", device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        if cfg.backbone == "resnet":
            self.resnet = ResNet(50, (1, 2, 3), 64, device=device)
            chans = resnet_channels(50, 64)[1:]
            if cfg.dcn:
                self.dcn_s3 = DeformConv2d(chans[1], chans[1], device=device)
                self.dcn_s4 = DeformConv2d(chans[2], chans[2], device=device)
            for i, c in enumerate(chans):
                self.add_module(f"fpn_lat{i}", Conv(c, D, (1, 1), device=device))
            for i in range(cfg.num_levels):
                self.add_module(f"fpn_out{i}", Conv(D, D, (3, 3), device=device))
        else:
            c = 3
            for i, w in enumerate((16, 32, 64)):
                self.add_module(f"Conv_{i}", Conv(c, w, (3, 3), 2, device=device))
                self.add_module(f"BatchNorm_{i}", BatchNorm(w, device))
                if 3 - i <= cfg.num_levels:
                    self.add_module(f"neck{i}", Conv(w, D, (1, 1), device=device))
                c = w
        H, W = cfg.bev_hw
        self.bev_queries = nn.Parameter(torch.empty((H * W, D), device=device))
        self.pos_row = nn.Parameter(torch.empty((H, D // 2), device=device))
        self.pos_col = nn.Parameter(torch.empty((W, D // 2), device=device))
        for i in range(cfg.enc_layers):
            self.add_module(f"layer{i}", EncoderLayer(D, cfg.bev_hw, cfg.num_heads, 4,
                                                      cfg.num_levels, 8, device))

    def forward(self, imgs, lidar2img):
        cfg = self.cfg
        if cfg.backbone == "resnet":
            feats = self.resnet(imgs)
            if cfg.dcn:
                feats[1] = self.dcn_s3(feats[1])
                feats[2] = self.dcn_s4(feats[2])
            lat = [getattr(self, f"fpn_lat{i}")(f) for i, f in enumerate(feats)]
            for i in range(len(lat) - 1, 0, -1):
                Ht, Wt = lat[i - 1].shape[2:]
                Hs, Ws = lat[i].shape[2:]
                # jax.image.resize "nearest": source index floor((i + 0.5) * in / out)
                iy = torch.floor((torch.arange(Ht) + 0.5) * Hs / Ht).long()
                ix = torch.floor((torch.arange(Wt) + 0.5) * Ws / Wt).long()
                lat[i - 1] = lat[i - 1] + lat[i][:, :, iy][:, :, :, ix]
            levels = [getattr(self, f"fpn_out{i}")(lat[i]) for i in range(cfg.num_levels)]
        else:
            levels, x = [], imgs
            for i in range(3):
                x = F.relu(getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(x)))
                if hasattr(self, f"neck{i}"):
                    levels.append(getattr(self, f"neck{i}")(x))
        H, W = cfg.bev_hw
        D = cfg.embed_dim
        pos = torch.cat([self.pos_row[:, None, :].expand(H, W, D // 2),
                         self.pos_col[None, :, :].expand(H, W, D // 2)], -1)
        h = self.bev_queries + pos.reshape(H * W, D)
        zs = (np.linspace(-3.0, 3.0, cfg.num_z_anchors) if cfg.num_z_anchors > 1 else [0.0])
        ref_pix, valid = project_bev_to_cameras(cfg.bev_hw, cfg.roi_size, lidar2img,
                                                cfg.img_size, levels[0].shape[2:], tuple(zs))
        for i in range(cfg.enc_layers):
            h = getattr(self, f"layer{i}")(h, ref_pix, levels, valid)
        return h.reshape(H, W, D).permute(2, 0, 1)


class ConvGRU(nn.Module):
    def __init__(self, C: int, device=None):
        super().__init__()
        self.convz = Conv(2 * C, C, (1, 1), bias=False, device=device)
        self.convr = Conv(2 * C, C, (1, 1), bias=False, device=device)
        self.convq = Conv(2 * C, C, (1, 1), bias=False, device=device)
        self.LayerNorm_0 = LayerNorm(C, device)

    def forward(self, h, x):
        hx = torch.cat([h, x])[None]
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = self.convq(torch.cat([r * h[None], x[None]], 1))
        out = (1 - z) * h[None] + z * q
        return self.LayerNorm_0(out[0].permute(1, 2, 0)).permute(2, 0, 1)


class PriorFusion2D(nn.Module):
    def __init__(self, pc_range, voxel_size, D: int, voxel_channels: int, device=None):
        super().__init__()
        self.resolution = voxel_resolution(pc_range, voxel_size)
        self.z_pooled = int((pc_range[5] - pc_range[2]) / voxel_size[2]) // 4
        self.VoxelFeatureExtractor_0 = VoxelFeatureExtractor(voxel_channels, D, device)
        self._ConvBNReLU_0 = _ConvBNReLU(4 * D, D, 1, device=device)
        self._ConvBNReLU_1 = _ConvBNReLU(D, D, 3, device=device)
        self._ConvBNReLU_2 = _ConvBNReLU(2 * D, D, 1, device=device)
        self._ConvBNReLU_3 = _ConvBNReLU(D, D, 3, device=device)

    def forward(self, bev, feats, coords, valid):  # bev (C, h, w); one sample
        grid = formulate_voxels(self.VoxelFeatureExtractor_0(feats), coords, valid,
                                self.resolution)  # (rx, ry, rz, hidden)
        vox = grid.permute(3, 1, 0, 2)  # (hidden, h = ry, w = rx, z = rz)
        hidden, h, w, _ = vox.shape
        pooled = vox.reshape(hidden, h, w, 4, self.z_pooled).amax(-1)  # (hidden, h, w, 4)
        x = pooled.permute(0, 3, 1, 2).reshape(1, hidden * 4, h, w)
        x = self._ConvBNReLU_1(self._ConvBNReLU_0(x))
        if tuple(x.shape[-2:]) != tuple(bev.shape[-2:]):
            x = _resize_bilinear(x, bev.shape[-2:])
        x = torch.cat([bev[None], x], 1)
        return self._ConvBNReLU_3(self._ConvBNReLU_2(x))[0]


class MultiHeadDotProductAttention(nn.Module):
    def __init__(self, D: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.query, self.key = Dense(D, D, device), Dense(D, D, device)
        self.value, self.out = Dense(D, D, device), Dense(D, D, device)

    def forward(self, x_q, x_k, x_v):
        Q, D = x_q.shape
        hd = D // self.heads
        heads = []
        for h in range(self.heads):
            sl = slice(h * hd, (h + 1) * hd)
            q = self.query(x_q)[:, sl] / math.sqrt(hd)
            w = torch.softmax(q @ self.key(x_k)[:, sl].T, -1)
            heads.append(w @ self.value(x_v)[:, sl])
        return self.out(torch.cat(heads, -1))


class DecoderDeformableAttention(nn.Module):
    def __init__(self, D: int, heads: int, points: int, device=None):
        super().__init__()
        self.heads = heads
        self.sampling_offsets = Dense(D, heads * points * 2, device)
        self.attention_weights = Dense(D, heads * points, device)
        self.value_proj = Dense(D, D, device)
        self.output_proj = Dense(D, D, device)

    def forward(self, queries, ref_pts, bev_rows, H, W):
        Q, D = queries.shape
        Hh, P = self.heads, ref_pts.shape[1]
        offsets = self.sampling_offsets(queries).reshape(Q, Hh, P, 2)
        attn = torch.softmax(self.attention_weights(queries).reshape(Q, Hh, P), -1)
        value = self.value_proj(bev_rows)
        px = ref_pts[:, None, :, 0] * W + offsets[..., 0]
        py = ref_pts[:, None, :, 1] * H + offsets[..., 1]
        taps = head_taps(value, Hh, px, py, H, W)
        return self.output_proj((taps * attn[..., None]).sum(2).reshape(Q, D))


class DecoderLayer(nn.Module):
    def __init__(self, D: int, heads: int, points: int, device=None):
        super().__init__()
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(D, heads, device)
        self.LayerNorm_0 = LayerNorm(D, device)
        self.cross_attn = DecoderDeformableAttention(D, heads, points, device)
        self.LayerNorm_1 = LayerNorm(D, device)
        self.Dense_0 = Dense(D, 2 * D, device)
        self.Dense_1 = Dense(2 * D, D, device)
        self.LayerNorm_2 = LayerNorm(D, device)

    def forward(self, q, bev_rows, H, W, ref, query_pos):
        q = self.LayerNorm_0(q + self.MultiHeadDotProductAttention_0(q + query_pos,
                                                                     q + query_pos, q))
        q = self.LayerNorm_1(q + self.cross_attn(q + query_pos, ref, bev_rows, H, W))
        return self.LayerNorm_2(q + self.Dense_1(F.relu(self.Dense_0(q))))


class MotionMLP(nn.Module):
    def __init__(self, D: int, device=None):
        super().__init__()
        self.fc1 = Dense(D + 12, D, device)
        self.fc2 = Dense(D, D, device)

    def forward(self, q, pose):
        h = torch.cat([q, pose.reshape(1, 12).expand(q.shape[0], 12)], -1)
        return self.fc2(F.relu(self.fc1(h)))


class MapDetectorHead(nn.Module):
    def __init__(self, cfg: "StreamMapNetConfig", device=None):
        super().__init__()
        self.cfg = cfg
        H, W = cfg.bev_hw
        D, Q, P, L = cfg.embed_dim, cfg.num_queries, cfg.num_points, cfg.dec_layers
        self.bev_proj = Dense(D, D, device)
        self.bev_pos = nn.Parameter(torch.empty((H, W, D), device=device))
        self.queries = nn.Parameter(torch.empty((Q, D), device=device))
        self.query_pos = nn.Parameter(torch.empty((Q, D), device=device))
        for lid in range(L):
            self.add_module(f"cls_head{lid}", Dense(D, cfg.num_classes, device))
            self.add_module(f"reg_hidden{lid}", Dense(D, D, device))
            self.add_module(f"reg_head{lid}", Dense(D, P * 2, device))
        self.reference_points_embed = Dense(D, P * 2, device)
        self.query_update = MotionMLP(D, device)
        for lid in range(L):
            self.add_module(f"dec{lid}", DecoderLayer(D, cfg.num_heads, P, device))

    def reg(self, x, lid):
        return getattr(self, f"reg_head{lid}")(F.relu(getattr(self, f"reg_hidden{lid}")(x)))

    def forward(self, bev, prev_queries=None, prev_ref_pts=None, pose=None, keep=None):
        """``keep``: the current queries to keep at the propagation stage, in
        order (a program's choice, held to this reference's scores by
        ``order_gap``), or None to choose them here."""
        cfg = self.cfg
        C, H, W = bev.shape
        Q, P, L = cfg.num_queries, cfg.num_points, cfg.dec_layers
        rw, rh = cfg.roi_size
        bev_rows = (self.bev_proj(bev.reshape(C, H * W).T).reshape(H, W, -1)
                    + self.bev_pos).reshape(H * W, -1)
        q = self.queries
        ref = torch.sigmoid(self.reference_points_embed(q)).reshape(Q, P, 2)
        prop_q = prop_ref = prop_pred = None
        if prev_queries is not None:
            prop_q = prev_queries + self.query_update(prev_queries, pose[:3].reshape(-1))
            roi = torch.tensor([rw, rh], device=bev.device)
            origin = torch.tensor([-rw / 2, -rh / 2], device=bev.device)
            den = prev_ref_pts * roi + origin
            den4 = torch.cat([den, torch.zeros_like(den[..., :1]), torch.ones_like(den[..., :1])],
                             -1)
            cur = (den4.double() @ pose.double().T).float()
            prop_ref = torch.clamp((cur[..., :2] - origin) / roi, 0.0, 1.0)
            prop_pred = torch.sigmoid(self.reg(prop_q, L - 1)).reshape(-1, P, 2)
        all_scores, all_pts, gaps = [], [], []
        for lid in range(L):
            if lid == 1 and prop_q is not None:
                scores = getattr(self, f"cls_head{lid}")(q).max(-1).values
                if keep is None:
                    keep = top(scores, Q - prop_q.shape[0])
                gaps.append(order_gap(scores, keep))
                q = torch.cat([prop_q, q[keep]])
                ref = torch.cat([prop_ref, ref[keep]])
            q = getattr(self, f"dec{lid}")(q, bev_rows, H, W, ref, self.query_pos)
            ref = torch.sigmoid(self.reg(q, lid).reshape(Q, P, 2))
            all_scores.append(getattr(self, f"cls_head{lid}")(q))
            all_pts.append(ref)
        out = {"scores": all_scores[-1],
               "lines": (all_pts[-1] - 0.5) * torch.tensor([rw, rh], device=bev.device),
               "queries": q, "ref_pts": ref, "all_scores": torch.stack(all_scores),
               "all_pts": torch.stack(all_pts), "order_gaps": gaps}
        if prop_pred is not None:
            out["prop_pred_points"] = prop_pred
            out["keep"] = keep
        return out


def top(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest scores' indices, largest first (ties to the lower index)."""
    return torch.argsort(-scores, stable=True)[:k]


def order_gap(scores: torch.Tensor, chosen: torch.Tensor) -> float:
    """How far a top-k choice (``chosen``: indices, largest first) is from the
    order of ``scores``: the most by which a later choice outscores an
    earlier one or an unchosen query outscores a chosen one, over the
    largest |score|. 0 for the order of these scores; a choice made on
    scores that differ by rounding may reach the rounding there."""
    s = scores.double()
    picked = s[chosen]
    worst = torch.zeros((), dtype=s.dtype, device=s.device)
    if len(picked) > 1:
        worst = torch.maximum(worst, (picked[1:] - picked[:-1]).max())
    rest = torch.ones_like(s, dtype=torch.bool)
    rest[chosen] = False
    if rest.any():
        worst = torch.maximum(worst, s[rest].max() - picked.min())
    return float(worst / s.abs().max().clamp_min(1e-30))


def select_topk_for_propagation(out: Dict, k: int, index: Optional[torch.Tensor] = None):
    """The top-k queries by max class score with their reference points,
    and their indices (``index``: a program's choice, held to these scores
    by ``order_gap``)."""
    scores = out["scores"].max(-1).values
    if index is None:
        index = top(scores, k)
    out.setdefault("order_gaps", []).append(order_gap(scores, index))
    return out["queries"][index], out["ref_pts"][index], index


@dataclasses.dataclass(frozen=True)
class StreamMapNetConfig:
    bev_hw: Tuple[int, int] = (25, 50)
    roi_size: Tuple[float, float] = (60.0, 30.0)
    img_size: Tuple[int, int] = (32, 64)
    embed_dim: int = 64
    num_queries: int = 50
    num_points: int = 20
    num_classes: int = 3
    prior_pc_range: Optional[Sequence[float]] = None
    prior_voxel_size: Optional[Sequence[float]] = None
    prior_voxel_channels: int = 68
    topk_propagate: int = 10
    num_levels: int = 1
    num_z_anchors: int = 1
    backbone: str = "simple"
    dcn: bool = False
    enc_layers: int = 2
    dec_layers: int = 2
    num_heads: int = 4


class StreamMapNet(nn.Module):
    """Streaming BEV (ConvGRU), prior fusion when the configuration has a
    prior range, and the head; ``forward`` serves one frame."""

    def __init__(self, cfg: StreamMapNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = BEVEncoder(cfg, device)
        self.stream_fusion = ConvGRU(cfg.embed_dim, device)
        if cfg.prior_pc_range is not None:
            self.prior_fusion = PriorFusion2D(cfg.prior_pc_range, cfg.prior_voxel_size,
                                              cfg.embed_dim, cfg.prior_voxel_channels, device)
        self.head = MapDetectorHead(cfg, device)

    def forward(self, imgs, lidar2img, prev_bev=None, prev2curr=None, prev_queries=None,
                prev_ref_pts=None, prior_feats=None, prior_coords=None, prior_valid=None,
                keep=None, prop_index=None):
        """One frame: the previous frame's BEV, 2D ego motion (3, 3) and
        hand-off, or None on a stream's first frame. ``keep`` and
        ``prop_index``: a program's top-k choices to follow (the decoder's
        kept queries, the hand-off), each held to this reference's scores in
        ``order_gaps``; None to choose here."""
        cfg = self.cfg
        bev = self.backbone(imgs, lidar2img)
        if prev_bev is not None:
            bev = self.stream_fusion(warp_bev(prev_bev, prev2curr, cfg.roi_size), bev)
        if prior_feats is not None:
            bev = self.prior_fusion(bev, prior_feats, prior_coords, prior_valid)
        pose = None
        if prev_queries is not None:
            pose = torch.eye(4, device=bev.device)
            pose[:2, :2] = prev2curr[:2, :2]
            pose[:2, 3] = prev2curr[:2, 2]
        out = self.head(bev, prev_queries, prev_ref_pts, pose, keep)
        out["bev"] = bev
        out["prop_queries"], out["prop_ref_pts"], out["prop_index"] = (
            select_topk_for_propagation(out, cfg.topk_propagate, prop_index))
        return out
