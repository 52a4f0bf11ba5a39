"""The stage-3 side of the prior contract in the port (prior/consume.py and
native.points_to_voxel) against the JAX package's, on the same pickles and
RandomState draws, on the CPU. Everything is numpy or C++ on the host, so
the outputs must be equal, not close:

  * the first-come voxelizer: the port's C++ (native/voxelize.cpp), its
    numpy version and the JAX package's C++ give identical voxels, coords
    and counts, with both caps (max_voxels, max_points) reached;
  * CityPriors: the crop of tile pickles written in the extraction schema
    (points f32, features f16, colours f32, hits, origin), two parts of
    one city and a city with none;
  * VoxelizePriorPoints: the BEV-aug replay (rotation, flips, scale),
    random_drop and pose noise from a seeded RandomState;
  * pad_prior_voxels: the padded (B, V, 68) / (B, V, 3) / (B, V) inputs as
    the JAX package's Stage3OccDataset.batch builds them.
"""

import pickle

import numpy as np
import pytest

from presight_tpu import native as jax_native
from presight_tpu.prior import consume as JC
from presight_tpu_torch import kernels, native
from presight_tpu_torch.prior import consume as PC

PC_RANGE = [-40.0, -40.0, -2.0, 40.0, 40.0, 6.0]
VOXEL = [0.4, 0.4, 0.4]


def _write_part(root, city, part, n, seed, centre):
    rng = np.random.RandomState(seed)
    origin = np.asarray(centre, np.float32) * [-1, -1, 1]
    pts = rng.uniform([-45, -45, -3], [45, 45, 7], (n, 3)).astype(np.float32)
    d = root / "camera_priors" / city
    d.mkdir(parents=True, exist_ok=True)
    with open(d / f"{city}-c{part}.pkl", "wb") as f:
        pickle.dump({"points": pts, "features": rng.randn(n, 64).astype(np.float16),
                     "colors": rng.rand(n, 3).astype(np.float32),
                     "hits": rng.randint(1, 40, n).astype(np.int64),
                     "origin": origin.astype(np.float32)}, f)


@pytest.fixture(scope="module")
def city_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("priors")
    _write_part(root, "boston", 0, 30000, 0, (100.0, 50.0, 0.0))
    _write_part(root, "boston", 1, 20000, 1, (110.0, 40.0, 0.0))
    return root


def test_first_come_voxelizer_cpp_numpy_and_jax_agree():
    rng = np.random.RandomState(3)
    pts = np.concatenate([rng.uniform([-41, -41, -2.5], [41, 41, 6.5], (6000, 3)),
                          rng.randn(6000, 5)], 1).astype(np.float32)
    pts[:2000, :3] = pts[0, :3] + rng.rand(2000, 3).astype(np.float32) * 0.3  # one dense voxel
    pts[2000:2100, :3] = np.float32(PC_RANGE[:3]) + rng.randint(0, 200, (100, 3)) * np.float32(0.4)
    for max_points, max_voxels in ((35, 1500), (5, 20000)):
        got = native.points_to_voxel(pts, VOXEL, PC_RANGE, max_points, max_voxels)
        with kernels.plain_versions():
            plain = native.points_to_voxel(pts, VOXEL, PC_RANGE, max_points, max_voxels)
        want = jax_native.points_to_voxel(pts, VOXEL, PC_RANGE, max_points, max_voxels)
        for g, p, w in zip(got, plain, want):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(p, w)
        assert got[2].max() == max_points
    assert len(native.points_to_voxel(pts, VOXEL, PC_RANGE, 35, 1500)[0]) == 1500


def test_city_priors_crop_matches_jax(city_root):
    port = PC.CityPriors(str(city_root), {"boston": 2}, PC_RANGE)
    ref = JC.CityPriors(str(city_root), {"boston": 2}, PC_RANGE)
    assert port.n_dim_feats == ref.n_dim_feats == 64
    for field in ("xyz", "features", "hits"):
        np.testing.assert_array_equal(getattr(port.priors["boston"], field),
                                      getattr(ref.priors["boston"], field))
    q = [np.cos(0.2), 0.0, 0.0, np.sin(0.2)]
    got = port.get_prior_points("boston", [105.0, 45.0, 0.0], q)
    want = ref.get_prior_points("boston", [105.0, 45.0, 0.0], q)
    assert len(got) == len(want) > 1000
    for field in ("xyz", "features", "hits"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert len(port.get_prior_points("singapore", [0, 0, 0], [1, 0, 0, 0])) == 0


@pytest.mark.parametrize("aug", [
    dict(),
    dict(rotate_bda=13.0, flip_dx=True, scale_ratio=1.05),
    dict(rotate_bda=-7.0, flip_dy=True, random_drop=True, pose_error_scale=0.1),
])
def test_voxelize_prior_points_matches_jax(city_root, aug):
    aug = dict(aug)
    kw = {k: aug.pop(k) for k in ("random_drop", "pose_error_scale") if k in aug}
    pts = PC.CityPriors(str(city_root), {"boston": 2}, PC_RANGE).get_prior_points(
        "boston", [105.0, 45.0, 0.0], [1.0, 0.0, 0.0, 0.0])
    ref_pts = JC.PriorPoints(pts.xyz, pts.features, pts.hits)
    got = PC.VoxelizePriorPoints(PC_RANGE, VOXEL, **kw)(
        pts, rng=np.random.RandomState(9), **aug)
    want = JC.VoxelizePriorPoints(PC_RANGE, VOXEL, **kw)(ref_pts, rng=np.random.RandomState(9),
                                                          **aug)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["prior_voxels"].shape[1] == 68 and len(got["prior_voxels"]) > 100


def test_pad_prior_voxels_as_the_jax_batch():
    rng = np.random.RandomState(2)
    samples = [{"prior_voxels": rng.randn(n, 68).astype(np.float32),
                "prior_voxels_coords": rng.randint(0, 200, (n, 3)).astype(np.int32)}
               for n in (17, 40)]
    out = PC.pad_prior_voxels(samples, pad_to=32)
    assert out["prior_feats"].shape == (2, 32, 68) and out["prior_feats"].dtype == np.float32
    assert out["prior_coords"].shape == (2, 32, 3) and out["prior_coords"].dtype == np.int32
    np.testing.assert_array_equal(out["prior_valid"].sum(1), [17, 32])
    np.testing.assert_array_equal(out["prior_feats"][0, :17], samples[0]["prior_voxels"])
    np.testing.assert_array_equal(out["prior_feats"][0, 17:], 0.0)
    np.testing.assert_array_equal(out["prior_coords"][1], samples[1]["prior_voxels_coords"][:32])
    assert PC.pad_prior_voxels(samples)["prior_feats"].shape == (2, 40, 68)
