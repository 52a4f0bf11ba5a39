"""S3's plain versions (presight_tpu_torch/mapping/deformable.py), which the
CPU runs and the card tests hold the kernels to, against the benchmark
reference's four-gather taps (portbench/reference/map.py), on the CPU:

  * ``msda_plain`` at the three attention sites' layouts (two queues over
    one table, three camera levels stacked in one table per camera, one
    level), with taps at exact integers, on the maps' edges and off them,
    and zero attention weights;
  * ``deform_im2col_plain`` against ``deform_columns`` at stride 1 and 2;
  * the spatial cross-attention's per-camera compaction against the
    reference's uncompacted, masked sum: equal while no camera overflows
    its capacity.

Tolerance: 1e-6 of the largest output (the same products, summed over the
heads at once here and head by head there)."""

from __future__ import annotations

import pytest
import torch

from test_torch_map_model import RM, one_thread  # noqa: F401

from presight_tpu_torch.mapping import bev_encoder as PB
from presight_tpu_torch.mapping.deformable import deform_im2col_plain, level_rows, msda_plain


def gap(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def reference_msda(value, levels, loc, attn):
    """The same sum from the reference's taps: per map, level and head."""
    B, Q, Hh, L, T = attn.shape
    D = value.shape[2]
    out = torch.zeros(B, Q, Hh, D // Hh)
    for b in range(B):
        for l, (H, W, start) in enumerate(levels):
            rows = value[b, start:start + H * W]
            taps = RM.head_taps(rows, Hh, loc[b, :, :, l, :, 0], loc[b, :, :, l, :, 1], H, W)
            out[b] += (taps * attn[b, :, :, l, :, None]).sum(2)
    return out.reshape(B, Q, D)


@pytest.mark.parametrize("site,B,Q,Hh,shapes,T,same_rows", [
    ("tsa", 1, 40, 4, [(5, 8), (5, 8)], 4, True),
    ("sca", 3, 30, 4, [(8, 10), (4, 5), (2, 3)], 8, False),
    ("decoder", 1, 12, 8, [(6, 9)], 20, False)])
def test_msda_plain_matches_the_reference_taps(site, B, Q, Hh, shapes, T, same_rows):
    g = torch.Generator().manual_seed(len(site))
    levels = [(H, W, 0) for H, W in shapes] if same_rows else level_rows(shapes)
    R = max(s + H * W for H, W, s in levels)
    value = torch.randn(B, R, Hh * 8, generator=g)
    dims = torch.tensor([[W, H] for H, W in shapes], dtype=torch.float32)
    loc = torch.rand(B, Q, Hh, len(shapes), T, 2, generator=g) * (dims[:, None] + 3) - 1.5
    loc[:, ::3] = torch.round(loc[:, ::3])
    loc[:, ::5, ..., 0] = -1.0
    loc[:, ::7, ..., 1] = dims[:, 1, None] - 1.0
    attn = torch.rand(B, Q, Hh, len(shapes), T, generator=g)
    attn[:, ::4] = 0.0
    got = msda_plain(value, levels, loc, attn)
    assert gap(got, reference_msda(value, levels, loc, attn)) < 1e-6


@pytest.mark.parametrize("stride", [1, 2])
def test_deform_im2col_plain_matches_the_reference_columns(stride):
    g = torch.Generator().manual_seed(stride)
    x = torch.randn(2, 7, 9, 5, generator=g)
    Ho, Wo = -(-7 // stride), -(-9 // stride)
    off = torch.randn(2, Ho, Wo, 9, 2, generator=g) * 1.5
    off[:, ::2] = torch.round(off[:, ::2])
    mask = torch.rand(2, Ho, Wo, 9, generator=g)
    got = deform_im2col_plain(x, off, mask, 3, stride)
    assert got.shape == (2 * Ho * Wo, 9 * 5)
    assert gap(got, RM.deform_columns(x, off, mask, 3, stride)) < 1e-6


def test_sca_compaction_equals_the_uncompacted_sum_without_overflow():
    g = torch.Generator().manual_seed(5)
    Q, D, N, A = 48, 32, 3, 4
    ref = RM.FusedDeformableCore(D, 4, 8, 2)
    for p in ref.parameters():
        p.data = torch.randn(p.shape, generator=g) / (p.shape[-1] ** 0.5 if p.dim() > 1 else 1)
    queries = torch.randn(Q, D, generator=g)
    ref_pix = torch.rand(N, A, Q, 2, generator=g) * torch.tensor([10.0, 8.0])
    valid = torch.rand(N, A, Q, generator=g) > 0.8
    valid[:, :, Q // 2:] = False  # every camera sees at most half the queries
    feats = [torch.randn(N, D, 8, 10, generator=g), torch.randn(N, D, 4, 5, generator=g)]
    with torch.no_grad():
        want, want_hits = ref(queries, ref_pix, feats, valid)
        port = PB.FusedDeformableCore(D, 4, 8, 2, capacity_frac=0.5)
        port.load_state_dict(ref.state_dict())
        got, hits = port(queries, ref_pix, feats, valid)
    assert port.capacity(Q) == Q // 2 and (port.n_valid <= Q // 2).all()
    assert torch.equal(hits, want_hits) and gap(got, want) < 1e-6
