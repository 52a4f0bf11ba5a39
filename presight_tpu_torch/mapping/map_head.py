"""MapDetectorHead: DETR-style vector-map decoding with streaming queries,
the port of presight_tpu/mapping/map_head.py's forward (reference
online-mapping/plugin/models/heads/MapDetectorHead.py and
transformer_utils/MapTransformer.py:24-155):

* each query carries ``num_points`` normalised 2D reference points,
  initialised by ``reference_points_embed``;
* decoder layer: multi-head self-attention -> norm -> single-level
  deformable cross-attention around the query's own reference points on
  the BEV (S3) -> norm -> FFN -> norm; after every layer the layer's
  regression branch re-predicts the points (sigmoid; the JAX package's
  ``predict_refine`` variant, unused by any config, is not ported);
* streaming: at the second layer the top-(Q - k) current queries by
  class score are kept and the k propagated ones, updated by a
  pose-conditioned MotionMLP and with their reference points moved by the
  ego motion, go first.

Training (losses, matching) stays in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Dense
from ..ops.math import clip
from ..utils.profiler import span
from .conv_gru import LayerNorm
from .deformable import msda


class MultiHeadDotProductAttention(nn.Module):
    """flax.linen.MultiHeadDotProductAttention (no dropout): query, key and
    value projections to (heads, D / heads), softmax(q k / sqrt(D / heads)),
    the output projection. Each projection is a Dense (D, D) here; the
    bridge reshapes flax's (D, heads, hd) kernels."""

    def __init__(self, embed_dim: int, num_heads: int, device=None):
        super().__init__()
        self.heads = num_heads
        self.query = Dense(embed_dim, embed_dim, device)
        self.key = Dense(embed_dim, embed_dim, device)
        self.value = Dense(embed_dim, embed_dim, device)
        self.out = Dense(embed_dim, embed_dim, device)

    def forward(self, inputs_q, inputs_k, inputs_v):
        Q, D = inputs_q.shape
        Hh = self.heads
        hd = D // Hh
        q = self.query(inputs_q).reshape(Q, Hh, hd) / math.sqrt(hd)
        k = self.key(inputs_k).reshape(-1, Hh, hd)
        v = self.value(inputs_v).reshape(-1, Hh, hd)
        w = torch.softmax(torch.einsum("qhd,khd->hqk", q, k), -1)
        return self.out(torch.einsum("hqk,khd->qhd", w, v).reshape(Q, D))


class DecoderDeformableAttention(nn.Module):
    """CustomMSDeformableAttention (one level): per head one learned offset
    and weight around each of the query's reference points, softmax over
    the points; the taps through S3."""

    def __init__(self, embed_dim: int, num_heads: int, num_points: int, device=None):
        super().__init__()
        D = embed_dim
        self.heads, self.points = num_heads, num_points
        self.sampling_offsets = Dense(D, num_heads * num_points * 2, device)
        self.attention_weights = Dense(D, num_heads * num_points, device)
        self.value_proj = Dense(D, D, device)
        self.output_proj = Dense(D, D, device)

    def forward(self, queries, ref_pts, bev_rows, bev_hw: Tuple[int, int]):
        """queries (Q, D); ref_pts (Q, P, 2) normalised (x, y); bev_rows
        (H * W, D). Returns (Q, D)."""
        Q, D = queries.shape
        Hh, P = self.heads, ref_pts.shape[1]
        H, W = bev_hw
        offsets = self.sampling_offsets(queries).reshape(Q, Hh, P, 2)
        attn = torch.softmax(self.attention_weights(queries).reshape(Q, Hh, P), -1)
        value = self.value_proj(bev_rows)
        px = ref_pts[:, None, :, 0] * W + offsets[..., 0]  # (Q, Hh, P)
        py = ref_pts[:, None, :, 1] * H + offsets[..., 1]
        loc = torch.stack([px, py], -1).reshape(1, Q, Hh, 1, P, 2)
        with span("map.msda"):
            out = msda(value[None], [(H, W, 0)], loc, attn.reshape(1, Q, Hh, 1, P))
        return self.output_proj(out[0])


class DecoderLayer(nn.Module):
    """self_attn -> norm -> cross_attn -> norm -> ffn -> norm (config
    :205-209)."""

    def __init__(self, embed_dim: int, num_heads: int, num_points: int, device=None):
        super().__init__()
        D = embed_dim
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(D, num_heads, device)
        self.LayerNorm_0 = LayerNorm(D, device)
        self.cross_attn = DecoderDeformableAttention(D, num_heads, num_points, device)
        self.LayerNorm_1 = LayerNorm(D, device)
        self.Dense_0 = Dense(D, 2 * D, device)
        self.Dense_1 = Dense(2 * D, D, device)
        self.LayerNorm_2 = LayerNorm(D, device)

    def forward(self, q, bev_rows, bev_hw, ref_pts, query_pos):
        qp = q + query_pos
        q = self.LayerNorm_0(q + self.MultiHeadDotProductAttention_0(qp, qp, q))
        q = self.LayerNorm_1(q + self.cross_attn(q + query_pos, ref_pts, bev_rows, bev_hw))
        return self.LayerNorm_2(q + self.Dense_1(F.relu(self.Dense_0(q))))


class MotionMLP(nn.Module):
    """query_update: propagated queries conditioned on the flattened (3, 4)
    prev -> curr ego transform."""

    def __init__(self, embed_dim: int, device=None):
        super().__init__()
        self.fc1 = Dense(embed_dim + 12, embed_dim, device)
        self.fc2 = Dense(embed_dim, embed_dim, device)

    def forward(self, q, pose_encoding):
        h = torch.cat([q, pose_encoding.expand(q.shape[0], 12)], -1)
        return self.fc2(F.relu(self.fc1(h)))


class MapDetectorHead(nn.Module):
    """BEV (C, H, W) -> the last layer's class logits and polyline points,
    with streaming query propagation. One sample, served: the per-layer
    outputs and the propagated queries' own points, which only training's
    losses read, are not computed."""

    PROP_ADD_STAGE = 1  # the decoder layer before which propagated queries join

    def __init__(self, bev_hw: Tuple[int, int], num_queries: int = 50, num_classes: int = 3,
                 num_points: int = 20, embed_dim: int = 64, num_layers: int = 2,
                 num_heads: int = 4, roi_size: Tuple[float, float] = (60.0, 30.0), device=None):
        super().__init__()
        H, W = bev_hw
        D = embed_dim
        self.bev_hw, self.num_queries, self.num_points = tuple(bev_hw), num_queries, num_points
        self.num_layers = num_layers
        self.bev_proj = Dense(D, D, device)
        self.bev_pos = nn.Parameter(torch.empty((H, W, D), device=device))
        self.queries = nn.Parameter(torch.empty((num_queries, D), device=device))
        self.query_pos = nn.Parameter(torch.empty((num_queries, D), device=device))
        for lid in range(num_layers):
            self.add_module(f"cls_head{lid}", Dense(D, num_classes, device))
            self.add_module(f"reg_hidden{lid}", Dense(D, D, device))
            self.add_module(f"reg_head{lid}", Dense(D, num_points * 2, device))
        self.reference_points_embed = Dense(D, num_points * 2, device)
        self.query_update = MotionMLP(D, device)
        for lid in range(num_layers):
            self.add_module(f"dec{lid}", DecoderLayer(D, num_heads, num_points, device))
        # the ROI's size and its lower corner in ego metres, made here so a
        # forward copies nothing from the host
        rw, rh = roi_size
        self.register_buffer("roi", torch.tensor([rw, rh], device=device), persistent=False)
        self.register_buffer("origin", torch.tensor([-rw / 2, -rh / 2], device=device),
                             persistent=False)

    def cls_head(self, x, lid: int):
        return getattr(self, f"cls_head{lid}")(x)

    def reg_branch(self, x, lid: int):
        return getattr(self, f"reg_head{lid}")(F.relu(getattr(self, f"reg_hidden{lid}")(x)))

    def forward(self, bev, prev_queries: Optional[torch.Tensor] = None,
                prev_ref_pts: Optional[torch.Tensor] = None,
                prev2curr: Optional[torch.Tensor] = None) -> Dict:
        """bev (C, H, W); prev_queries (k, D), prev_ref_pts (k, P, 2)
        normalised and prev2curr (4, 4) for streaming (all None on a
        stream's first frame)."""
        C, H, W = bev.shape
        Q, P = self.num_queries, self.num_points
        bev_rows = self.bev_proj(bev.reshape(C, H * W).T) + self.bev_pos.reshape(H * W, -1)
        q = self.queries
        ref = torch.sigmoid(self.reference_points_embed(q)).reshape(Q, P, 2)

        prop_q = prop_ref = None
        if prev_queries is not None and prev2curr is not None:
            pose_encoding = prev2curr[:3].reshape(-1).to(torch.float32)
            prop_q = prev_queries + self.query_update(prev_queries, pose_encoding)
            den = prev_ref_pts * self.roi + self.origin  # (k, P, 2) ego metres
            den4 = torch.cat([den, torch.zeros_like(den[..., :1]), torch.ones_like(den[..., :1])],
                             -1)
            cur = torch.einsum("lk,ijk->ijl", prev2curr.double(), den4.double()).float()
            prop_ref = clip((cur[..., :2] - self.origin) / self.roi, 0.0, 1.0)

        keep = None
        for lid in range(self.num_layers):
            if lid == self.PROP_ADD_STAGE and prop_q is not None:
                k = prop_q.shape[0]
                keep = torch.topk(self.cls_head(q, lid).max(-1).values, Q - k).indices
                q = torch.cat([prop_q, q[keep]])
                ref = torch.cat([prop_ref, ref[keep]])
            q = getattr(self, f"dec{lid}")(q, bev_rows, (H, W), ref, self.query_pos)
            ref = torch.sigmoid(self.reg_branch(q, lid).reshape(Q, P, 2))

        out = {"scores": self.cls_head(q, self.num_layers - 1),
               "lines": (ref - 0.5) * self.roi,
               "queries": q, "ref_pts": ref}
        if keep is not None:
            out["keep"] = keep  # the current queries kept at PROP_ADD_STAGE, in order
        return out


def select_topk_for_propagation(out: Dict, k: int):
    """Streaming hand-off: the k queries with the largest max class score,
    largest first, become the next frame's propagated set. Returns (their
    rows, their queries, their reference points)."""
    idx = torch.topk(out["scores"].max(-1).values, k).indices
    return idx, out["queries"][idx], out["ref_pts"][idx]
