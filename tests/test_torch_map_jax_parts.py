"""Parts of the online-mapping port against the JAX package's modules on the
CPU, through ``bridge.map_state_from_flax`` (numpy variables at ``init``'s
shapes, one eager ``apply`` each):

  * DeformConv2d (DCNv2) with offsets of one to two pixels, exact integers
    and taps off the map, through S3's plain version;
  * PriorFusion2D at the published grid's ratios (z pooled into 4 buckets, a
    prior grid twice the BEV's size, so the antialiased bilinear resize
    shrinks), BatchNorm statistics at random;
  * the spatial cross-attention when a camera sees more queries than its
    capacity: the overflowed queries lose that camera and its count, as
    the JAX package drops them, and the counters count the drops;
  * the temporal self-attention as StreamMapNet runs it (no previous BEV:
    the queue holds the current queries twice).

Tolerance: within 1e-5 of each output's largest value (sums in other
orders; measured ~1e-7).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presight_tpu.mapping import bev_encoder as JB
from presight_tpu.models.prior_fusion import PriorFusion2D as JaxPriorFusion2D
from presight_tpu_torch import bridge
from presight_tpu_torch.mapping import bev_encoder as PB
from presight_tpu_torch.models.prior_fusion import PriorFusion2D

T = torch.as_tensor


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: six test workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def variables(module, rng, *args, **kwargs):
    """numpy leaves at the module's shapes: kernels N(0, 1 / fan_in), biases
    N(0, 1) where they place taps (offset branches), others N(0, 0.1^2)
    round their identity; BatchNorm variances in [0.5, 1.5)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            s = v.shape
            if k == "var":
                a = rng.rand(*s) + 0.5
            elif len(s) >= 2:
                a = rng.randn(*s) / math.sqrt(np.prod(s[:-1]))
            elif k == "bias" and path[-1] in ("sampling_offsets", "offset_mask"):
                a = rng.randn(*s)
            else:
                a = rng.randn(*s) * 0.1 + (1.0 if k == "scale" else 0.0)
            out[k] = a.astype(np.float32)
        return out
    return walk(shapes)


def gap(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(got.double().numpy() - want).max() / np.abs(want).max())


def test_deform_conv_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 11, 12).astype(np.float32)
    jm = JB.DeformConv2d(features=8)
    v = variables(jm, rng, x)
    v["params"]["offset_mask"]["bias"][:6] = np.round(v["params"]["offset_mask"]["bias"][:6])
    want = jm.apply(v, x)  # (B, H, W, F)
    m = PB.DeformConv2d(12, 8)
    bridge.map_state_from_flax(v, m)
    with torch.no_grad():
        got = m(T(x).permute(0, 3, 1, 2))
    assert gap(got.permute(0, 2, 3, 1), want) < 1e-5


def test_prior_fusion_2d_matches_jax():
    rng = np.random.RandomState(1)
    pc, vs = (-50.0, -25.0, -3.0, 50.0, 25.0, 5.0), (2.5, 2.5, 1.0)  # grid 40 x 20 x 8
    V, C = 400, 16
    bev = rng.randn(1, C, 10, 20).astype(np.float32)
    feats = rng.randn(1, V, 68).astype(np.float32)
    # distinct voxels, as the prior contract gives them; (z, y, x) < (8, 20, 40)
    # with x < 12: the grid keeps x < 8 only (the reference's indexing)
    cells = rng.permutation(8 * 20 * 12)[:V]
    coords = np.stack([cells // 240, (cells // 12) % 20, cells % 12], -1)[None].astype(np.int32)
    valid = (rng.rand(1, V) > 0.1)
    jm = JaxPriorFusion2D(prior_pc_range=pc, prior_voxel_size=vs, bev_feats_channels=C,
                          hidden_channels=C)
    v = variables(jm, rng, bev, feats, coords, valid)
    want = jm.apply(v, bev, feats, coords, valid)
    m = PriorFusion2D(pc, vs, C, 68, hidden_channels=C)
    bridge.map_state_from_flax(v, m)
    m.eval()
    with torch.no_grad():
        got = m(T(bev), T(feats), T(coords), T(valid))
    assert got.shape == (1, C, 10, 20)
    assert gap(got, want) < 1e-5


def test_sca_overflow_drops_as_jax_does():
    """Capacity 0.3 of 60 queries (18 slots): camera 0 sees 40 queries and
    drops the last 22 in index order, camera 1 sees 10 and drops none."""
    rng = np.random.RandomState(2)
    Q, D, N, A = 60, 32, 2, 4
    shapes = [(6, 8), (3, 4)]
    queries = rng.randn(Q, D).astype(np.float32)
    ref_pix = (rng.rand(N, A, Q, 2) * np.array([8, 6]) + rng.randn(N, A, Q, 2) * 0.3
               ).astype(np.float32)
    valid = np.zeros((N, A, Q), bool)
    valid[0, :, :40] = rng.rand(A, 40) > 0.3
    valid[0, 0, :40] = True
    valid[1, 1, 20:30] = True
    feats = [rng.randn(N, H, W, D).astype(np.float32) for H, W in shapes]
    jm = JB.SpatialCrossAttention(embed_dim=D, num_heads=4, num_points=8, num_levels=2,
                                  capacity_frac=0.3)
    jargs = [jnp.asarray(queries), jnp.asarray(ref_pix), [jnp.asarray(f) for f in feats],
             jnp.asarray(valid)]
    v = variables(jm, rng, *jargs)
    want, sown = jm.apply(v, *jargs, mutable=["intermediates"])
    m = PB.SpatialCrossAttention(D, 4, 8, 2, capacity_frac=0.3)
    bridge.map_state_from_flax(v, m)
    with torch.no_grad():
        got = m(T(queries), T(ref_pix), [T(f).permute(0, 3, 1, 2) for f in feats], T(valid))
    assert gap(got, want) < 1e-5
    core = m.deformable_attention
    K = core.capacity(Q)
    assert K == 18 and core.n_valid.tolist() == [40, 10]
    overflow = jax.tree_util.tree_leaves(sown)[0]
    assert int(overflow) == max(n - K for n in core.n_valid.tolist()) == 22
    # with room for every query, nothing is dropped and the sum changes
    m_all = PB.SpatialCrossAttention(D, 4, 8, 2, capacity_frac=1.0)
    m_all.load_state_dict(m.state_dict())
    with torch.no_grad():
        every = m_all(T(queries), T(ref_pix), [T(f).permute(0, 3, 1, 2) for f in feats],
                      T(valid))
    assert gap(every, want) > 1e-3


def test_temporal_self_attention_matches_jax():
    rng = np.random.RandomState(3)
    H, W, D = 6, 8, 32
    query = rng.randn(H * W, D).astype(np.float32)
    jm = JB.TemporalSelfAttention(embed_dim=D, bev_hw=(H, W), num_heads=4, num_points=4)
    v = variables(jm, rng, query, None)
    m = PB.TemporalSelfAttention(D, (H, W), 4, 4)
    bridge.map_state_from_flax(v, m)
    with torch.no_grad():
        want = jm.apply(v, query, None)
        got = m(T(query))
    assert gap(got, want) < 1e-5
