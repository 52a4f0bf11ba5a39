"""The occupancy port's operations against the JAX package's, on the CPU
(seeded numpy inputs through both):

  * bev_pool_v2 (S1's plain version): voxel ranks exact, pooled values
    against JAX at rtol 1e-5 + atol 1e-6 (sums of a few f32 products in
    another order) with points placed on voxel faces, and against the loop
    oracle (which divides in float64) off the faces;
  * stereo_cost_volume (S2's plain version) on JAX's grid: softmax at
    atol 1e-6, costs at rtol 1e-6 + atol 1e-5 (sums over channels in
    another order), the bias mask equal, on post-ReLU features (exact
    zeros) and samples outside the image;
  * gen_stereo_grid and get_lidar_coor held separately at atol 1e-5 (JAX's
    jnp.linalg.inv and einsums against torch's: ulps apart);
  * grid_sample_2d at atol 1e-6, warp_bev at atol 2e-5 (its sample
    positions come through the two inverses of prev2curr, ulps apart, times
    the map's slope); formulate_voxels exactly,
    its (z, y, x)-into-(rx, ry, rz) quirk included;
  * flax's "SAME" padding: stride-2 convs on even and odd sizes (2D 3x3,
    1x1, 3D 3x3x3), the stem's explicit padding and the max-pool, and the
    two resizes (nearest in CustomFPN, bilinear upsampling in the prior
    fusion, borders included), at atol 1e-5.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presight_tpu.mapping.conv_gru import warp_bev as jax_warp_bev
from presight_tpu.models.prior_fusion import formulate_voxels as jax_formulate_voxels
from presight_tpu.occupancy import bev_pool as JB
from presight_tpu.occupancy import view_transformer as JV
from presight_tpu_torch.bridge import _kernel_to_port
from presight_tpu_torch.mapping.conv_gru import warp_bev
from presight_tpu_torch.models.prior_fusion import _resize_bilinear, formulate_voxels
from presight_tpu_torch.occupancy import bev_pool as PB
from presight_tpu_torch.occupancy import view_transformer as PV
from presight_tpu_torch.models.layers import Conv

T = torch.as_tensor


def _geometry(B=1, N=2, seed=0):
    """Cameras with general extrinsics, intrinsics and image augmentation."""
    rng = np.random.RandomState(seed)
    s2e = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
    for b in range(B):
        for n in range(N):
            yaw = rng.uniform(-np.pi, np.pi)
            R = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float64)
            Rz = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0],
                           [0, 0, 1]])
            s2e[b, n, :3, :3] = Rz @ R
    s2e[..., :3, 3] = rng.randn(B, N, 3) * 0.5
    intr = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    intr[..., 0, 0] = intr[..., 1, 1] = 40.0 + rng.rand(B, N)
    intr[..., 0, 2], intr[..., 1, 2] = 32.3, 16.1
    post_rots = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    post_rots[..., 0, 0] = post_rots[..., 1, 1] = 0.9
    post_trans = (rng.randn(B, N, 3) * [2.0, 2.0, 0.0]).astype(np.float32)
    bda = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    bda[:, 0, 0] = -1.0
    return s2e, intr, post_rots, post_trans, bda


def _k2s(B=1, N=2):
    c, s = np.cos(0.03), np.sin(0.03)
    k2s = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
    k2s[..., 0, 0] = k2s[..., 2, 2] = c
    k2s[..., 0, 2], k2s[..., 2, 0] = s, -s
    k2s[..., :3, 3] = [0.31, -0.02, 0.27]
    return k2s


LB, IV, GS = [-8.0, -8.0, -1.0], [0.8, 0.8, 0.5], (20, 20, 8)


def test_bev_pool_v2_matches_jax_and_loop_oracle():
    rng = np.random.RandomState(0)
    B, N, D, H, W, C = 2, 2, 5, 3, 4, 6
    depth = rng.rand(B, N, D, H, W).astype(np.float32)
    feat = rng.randn(B, N, H, W, C).astype(np.float32)
    coor = (rng.rand(B, N, D, H, W, 3) * 20 - 10).astype(np.float32)
    # a quarter of the points on voxel faces (and on the grid's outer faces)
    faces = rng.rand(B, N, D, H, W, 3) < 0.25
    k = rng.randint(-1, 22, coor.shape)
    coor = np.where(faces, np.float32(LB) + k * np.float32(IV), coor).astype(np.float32)
    ranks = PB.voxel_ranks(T(coor), LB, IV, GS).numpy()
    vox = np.asarray(jnp.floor((jnp.asarray(coor) - jnp.asarray(LB, jnp.float32))
                               / jnp.asarray(IV, jnp.float32)).astype(jnp.int32))
    inb = ((vox >= 0) & (vox < np.array(GS))).all(-1)
    want_ranks = np.where(inb, ((np.arange(B).reshape(B, 1, 1, 1, 1) * 8 + vox[..., 2]) * 20
                                + vox[..., 1]) * 20 + vox[..., 0], B * 8 * 20 * 20)
    np.testing.assert_array_equal(ranks, want_ranks)
    got = PB.bev_pool_v2(T(depth), T(feat), T(coor), LB, IV, GS).numpy()
    jax_out = np.asarray(jax.jit(JB.bev_pool_v2, static_argnums=(3, 4, 5))(
        depth, feat, coor, tuple(LB), tuple(IV), GS))
    np.testing.assert_allclose(got, jax_out, rtol=1e-5, atol=1e-6)
    assert (np.abs(got) > 0).any()
    # The loop oracle divides in float64, so it may put a point on a face
    # elsewhere: it is held on the points off the faces.
    off = np.where(faces, coor + np.float32(0.1), coor).astype(np.float32)
    oracle = PB.bev_pool_v2_reference(depth, feat, off, LB, IV, GS)
    got = PB.bev_pool_v2(T(depth), T(feat), T(off), LB, IV, GS).numpy()
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-6)


def _stereo_inputs(seed=0, BN=2, Hs=6, Ws=10, C=8, D=7):
    rng = np.random.RandomState(seed)
    prev = np.maximum(rng.randn(BN, Hs, Ws, C), 0).astype(np.float32)
    curr = np.maximum(rng.randn(BN, Hs, Ws, C), 0).astype(np.float32)
    grid = (rng.rand(BN, D * Hs * Ws, 2) * 2.6 - 1.3).astype(np.float32)
    grid[:, ::11] = -2.0  # behind the camera
    return prev, curr, grid, D


def test_stereo_cost_volume_matches_jax():
    prev, curr, grid, D = _stereo_inputs()
    BN, Hs, Ws, _ = curr.shape
    want = np.asarray(jax.jit(JV.stereo_cost_volume, static_argnums=(3,))(prev, curr, grid, D))
    warped = np.asarray(JV.grid_sample_2d(jnp.asarray(prev), jnp.asarray(grid)))
    warped = warped.reshape(BN, D, Hs, Ws, -1).transpose(0, 2, 3, 1, 4)
    want_mask = warped[..., 0] == 0.0
    want_cost = np.abs(curr[:, :, :, None] - warped).sum(-1) + 5.0 * want_mask
    prob, cost, mask = PV.stereo_cost_volume(T(prev), T(curr), T(grid), D, return_cost=True)
    assert prob.shape == (BN, Hs, Ws, D)
    assert 0 < want_mask.sum() < want_mask.size
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_allclose(cost.numpy(), want_cost, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(prob.numpy(), want, atol=1e-6)
    # without the bias, the mask changes nothing
    nob = PV.stereo_cost_volume(T(prev), T(curr), T(grid), D, bias=0.0).numpy()
    want_nob = np.asarray(jax.jit(JV.stereo_cost_volume, static_argnums=(3, 4))(
        prev, curr, grid, D, 0.0))
    np.testing.assert_allclose(nob, want_nob, atol=1e-6)


def test_gen_stereo_grid_and_lidar_coor_match_jax():
    geo = _geometry(2, 3, seed=4)
    s2e, intr, post_rots, post_trans, bda = geo
    k2s = _k2s(2, 3)
    k2s[1, 2, :3, :3] = np.diag([-1.0, 1.0, -1.0])  # looks backwards: every point behind it
    frustum = JV.create_frustum((1.0, 9.0, 0.5), (32, 64), 16)
    np.testing.assert_array_equal(PV.create_frustum((1.0, 9.0, 0.5), (32, 64), 16), frustum)
    want = np.asarray(jax.jit(JV.get_lidar_coor)(frustum, *geo))
    got = PV.get_lidar_coor(T(frustum), *map(T, geo)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)
    frustum_cv = JV.create_frustum((1.0, 9.0, 0.5), (32, 64), 4)
    want = np.asarray(jax.jit(JV.gen_stereo_grid, static_argnums=(5,))(
        frustum_cv, k2s, intr, post_rots, post_trans, (32, 64)))
    got = PV.gen_stereo_grid(T(frustum_cv), T(k2s), T(intr), T(post_rots), T(post_trans),
                             (32, 64)).numpy()
    assert got.shape == want.shape == (6, frustum_cv[..., 0].size, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)
    assert (got == -2.0).any() and (np.abs(got) < 1).any()


def test_grid_sample_2d_matches_jax():
    rng = np.random.RandomState(2)
    img = rng.randn(3, 7, 9, 4).astype(np.float32)
    grid = (rng.rand(3, 50, 2) * 2.8 - 1.4).astype(np.float32)
    grid[0, :9] = [[-1, -1], [1, 1], [-1, 1], [1, -1], [0, 0], [1.0001, 0], [-1.25, 0.5],
                   [0.5, 1.25], [-2, -2]]
    want = np.asarray(JV.grid_sample_2d(jnp.asarray(img), jnp.asarray(grid)))
    got = PV.grid_sample_2d(T(img), T(grid)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("size", [(9, 13), (10, 12)])
def test_warp_bev_matches_jax(size):
    rng = np.random.RandomState(3)
    H, W = size
    prev = rng.randn(5, H, W).astype(np.float32)
    a = 0.07
    p2c = np.array([[np.cos(a), -np.sin(a), 0.9], [np.sin(a), np.cos(a), -0.4], [0, 0, 1]],
                   np.float32)
    want = np.asarray(jax.jit(jax_warp_bev, static_argnums=(2,))(prev, p2c, (16.0, 12.0)))
    got = warp_bev(T(prev), T(p2c), (16.0, 12.0)).numpy()
    # the sample positions come through jnp.linalg.inv and torch.linalg.inv:
    # ulps apart (~1e-6 px at x ~ 13), times the map's slope (~3 a pixel)
    np.testing.assert_allclose(got, want, atol=2e-5)
    ident = warp_bev(T(prev), torch.eye(3), (16.0, 12.0)).numpy()
    np.testing.assert_allclose(ident, prev, atol=1e-5)  # pixel centres through metres and back


def test_formulate_voxels_matches_jax_quirk_included():
    rng = np.random.RandomState(5)
    V, C = 300, 4
    res = (12, 10, 6)  # (rx, ry, rz); coords come as (z, y, x) of a 6 x 10 x 12 grid
    feats = rng.randn(V, C).astype(np.float32)
    coords = np.unique(np.stack([rng.randint(0, 6, V), rng.randint(0, 10, V),
                                 rng.randint(0, 12, V)], -1), axis=0).astype(np.int32)
    feats = feats[:len(coords)]
    valid = rng.rand(len(coords)) > 0.2
    want = np.asarray(jax.jit(jax_formulate_voxels, static_argnums=(3,))(
        feats, coords, valid, res))
    got = formulate_voxels(T(feats), T(coords), T(valid), res).numpy()
    np.testing.assert_array_equal(got, want)
    # only voxels with x < rz survive the (z, y, x) -> [rx, ry, rz] scatter
    kept = valid & (coords[:, 2] < res[2])
    assert 0 < int((np.abs(got).sum(-1) > 0).sum()) == int(kept.sum())


def _masked_formulate_voxels(prior_feats, coords, valid, voxel_resolution):
    """formulate_voxels as boolean masks write it: the kept rows picked out
    (a data-dependent count, read back to the host on a card) and put into
    the grid."""
    rx, ry, rz = voxel_resolution
    i0, i1, i2 = coords.long().unbind(-1)
    keep = valid & (i0 >= 0) & (i0 < rx) & (i1 >= 0) & (i1 < ry) & (i2 >= 0) & (i2 < rz)
    grid = torch.zeros((rx * ry * rz, prior_feats.shape[-1]), dtype=prior_feats.dtype)
    grid[((i0 * ry + i1) * rz + i2)[keep]] = prior_feats[keep]
    return grid.reshape(rx, ry, rz, prior_feats.shape[-1])


def _voxel_case(case, V=240, C=5, res=(12, 10, 6), seed=11):
    """Distinct (z, y, x) coords of a 6 x 10 x 12 grid into res = (rx, ry,
    rz), with what ``case`` adds: padded rows, negative coordinates,
    coordinates past one bound or past all three, or no valid row."""
    rng = np.random.RandomState(seed)
    rx, ry, rz = res
    cells = rng.permutation(6 * 10 * 12)[:V]
    coords = np.stack([cells // 120, (cells // 12) % 10, cells % 12], -1).astype(np.int32)
    valid = np.ones(V, bool)
    if case == "padded":
        valid[rng.rand(V) < 0.3] = False
        coords[~valid] = 0  # padding as the prior contract writes it: zero coordinates
    elif case == "negative":
        coords[::4, rng.randint(0, 3)] *= -1
        coords[1::9] = -1
    elif case in ("past rx", "past ry", "past rz"):
        axis = ("past rx", "past ry", "past rz").index(case)
        bound = res[axis]
        coords[::3, axis] = bound + rng.randint(0, 3, len(coords[::3]))
    elif case == "past every bound":
        for axis in range(3):
            rows = slice(2 * axis, None, 6)
            coords[rows, axis] = res[axis] + rng.randint(0, 3, len(coords[rows]))
    elif case == "all invalid":
        valid[:] = False
    feats = rng.randn(V, C).astype(np.float32)
    return feats, coords, valid, res


VOXEL_CASES = ["padded", "negative", "past rx", "past ry", "past rz", "past every bound",
               "all invalid"]


@pytest.mark.parametrize("case", VOXEL_CASES)
def test_formulate_voxels_equals_the_masked_scatter(case):
    """The scatter that sends a dropped row to a spare row past the grid
    gives the masked scatter's grid and its gradient, bit for bit: a kept
    row takes its cell's gradient, a dropped one none."""
    feats, coords, valid, res = _voxel_case(case)
    g = torch.from_numpy(np.random.RandomState(3).randn(*res, feats.shape[1]).astype(np.float32))
    out = []
    for fn in (formulate_voxels, _masked_formulate_voxels):
        x = T(feats).clone().requires_grad_(True)
        grid = fn(x, T(coords), T(valid), res)
        (grid * g).sum().backward()
        out.append((grid.detach(), x.grad))
    (got, got_grad), (want, want_grad) = out
    assert torch.equal(got, want) and torch.equal(got_grad, want_grad)
    kept = (got_grad.abs().sum(-1) > 0).numpy()
    if case == "all invalid":
        assert not got.any() and not kept.any()
    else:
        assert 0 < kept.sum() < len(kept)


@pytest.mark.parametrize("case", ["past every bound", "all invalid"])
def test_formulate_voxels_matches_jax_past_the_grid(case):
    """JAX's dump slot crops coordinates at a bound and drops those past it,
    as the port drops both; with no valid row both grids are zero."""
    feats, coords, valid, res = _voxel_case(case)
    want = np.asarray(jax.jit(jax_formulate_voxels, static_argnums=(3,))(
        feats, coords, valid, res))
    got = formulate_voxels(T(feats), T(coords), T(valid), res).numpy()
    np.testing.assert_array_equal(got, want)


def _flax_conv_pair(kernel, stride, padding, size, channels=(3, 5), seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, *size, channels[0]).astype(np.float32)
    conv = fnn.Conv(channels[1], kernel, strides=(stride,) * len(kernel), padding=padding)
    variables = conv.init(jax.random.PRNGKey(seed), x)
    want = np.asarray(conv.apply(variables, x))
    port = Conv(channels[0], channels[1], kernel, stride, padding=padding)
    with torch.no_grad():
        port.weight.copy_(T(_kernel_to_port(np.array(variables["params"]["kernel"]))))
        port.bias.copy_(T(np.array(variables["params"]["bias"])))
        x_port = T(np.moveaxis(x, -1, 1).copy())
        got = np.moveaxis(port(x_port).numpy(), 1, -1)
    return got, want


@pytest.mark.parametrize("size", [(8, 12), (9, 13), (8, 13)])
@pytest.mark.parametrize("kernel,stride,padding", [
    ((3, 3), 2, "SAME"), ((1, 1), 2, "SAME"), ((3, 3), 1, "SAME"), ((1, 1), 1, "VALID"),
    ((7, 7), 2, [(3, 3), (3, 3)]),
])
def test_conv_pads_as_flax(size, kernel, stride, padding):
    got, want = _flax_conv_pair(kernel, stride, padding, size)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("size", [(4, 6, 8), (5, 7, 9)])
def test_conv3d_stride2_pads_as_flax(size):
    got, want = _flax_conv_pair((3, 3, 3), 2, "SAME", size)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("size", [(8, 12), (9, 13)])
def test_stem_max_pool_matches_flax(size):
    rng = np.random.RandomState(1)
    x = rng.randn(1, *size, 3).astype(np.float32)
    h = jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1), (0, 0)), constant_values=-jnp.inf)
    want = np.asarray(fnn.max_pool(h, (3, 3), strides=(2, 2), padding="VALID"))
    got = torch.nn.functional.max_pool2d(T(np.moveaxis(x, -1, 1).copy()), 3, 2, padding=1)
    np.testing.assert_array_equal(np.moveaxis(got.numpy(), 1, -1), want)


@pytest.mark.parametrize("method,src,dst", [("nearest", (4, 11), (8, 22)),
                                            ("bilinear", (5, 5), (10, 10)),
                                            ("bilinear", (50, 50), (100, 100))])
def test_resizes_match_jax_image_resize(method, src, dst):
    rng = np.random.RandomState(7)
    x = rng.randn(1, *src, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, *dst, 3), method))
    xt = T(np.moveaxis(x, -1, 1).copy())
    if method == "nearest":
        got = torch.nn.functional.interpolate(xt, size=dst, mode="nearest-exact")
    else:
        got = _resize_bilinear(xt, dst)
    got = np.moveaxis(got.numpy(), 1, -1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[:, [0, -1]], want[:, [0, -1]], atol=1e-6)  # borders
    np.testing.assert_allclose(got[:, :, [0, -1]], want[:, :, [0, -1]], atol=1e-6)
