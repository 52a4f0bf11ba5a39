"""The port's dataparser (presight_tpu_torch/data/dataparser.py) against
the JAX package's on the JAX package's own synthetic fixture, and the
port's k-means against scikit-learn's KMeans (the oracle here).

Tolerances: item fields, poses, intrinsics, the pose transformation,
k-means labels and the AABBs (a function of the labels) identical;
centroids within rtol 1e-5 of scikit-learn's (its Lloyd steps sum float32
points in chunked BLAS products, the port in numpy: the same float32
sums in another order).
"""

import dataclasses
import warnings

import numpy as np
import pytest
from sklearn.cluster import KMeans

from presight_tpu.data import dataparser as JP
from presight_tpu.data.synthetic import generate_scene as jax_generate_scene
from presight_tpu_torch import configs as TC
from presight_tpu_torch.data import dataparser as TP

ITEM_FIELDS = ("image_path", "W", "H", "image_index", "time", "video_id", "is_val",
               "is_key_frame", "depth_path", "mask_path", "seg_path", "feature_path")


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    return jax_generate_scene(tmp_path_factory.mktemp("synthetic"))


def _configs(root, num_aabbs):
    kw = dict(data_dir=root, location="synthetic-city", num_aabbs=num_aabbs,
              depth_type="lidar", centroids_dir=root / "centroids", train_split_fraction=0.9)
    return JP.DataParserConfig(**kw), TC.DataParserConfig(**kw)


@pytest.mark.parametrize("num_aabbs", [1, 2, 16])
@pytest.mark.parametrize("split", ["train", "val"])
def test_parse_matches_jax(fixture_dir, split, num_aabbs):
    jcfg, tcfg = _configs(fixture_dir, num_aabbs)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    ref, got = JP.parse(jcfg, split=split), TP.parse(tcfg, split=split)
    assert len(got.items) == len(ref.items) and len(got.all_items) == len(ref.all_items)
    for a, b in zip(got.all_items, ref.all_items):
        for name in ITEM_FIELDS:
            assert getattr(a, name) == getattr(b, name), name
        np.testing.assert_array_equal(a.c2w, b.c2w)
        np.testing.assert_array_equal(a.intrinsics, b.intrinsics)
        assert a.c2w.dtype == b.c2w.dtype and a.intrinsics.dtype == b.intrinsics.dtype
    assert [it.image_path for it in got.items] == [it.image_path for it in ref.items]
    np.testing.assert_array_equal(got.pose_transformation, ref.pose_transformation)
    assert got.pose_scale_factor == ref.pose_scale_factor and got.num_videos == ref.num_videos
    assert got.dino_to_rgb.keys() == ref.dino_to_rgb.keys()
    if split == "train":
        np.testing.assert_array_equal(got.predicted_labels, ref.predicted_labels)
        assert got.predicted_labels.dtype == ref.predicted_labels.dtype
        np.testing.assert_allclose(got.centroids, ref.centroids, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got.aabbs, ref.aabbs)
    else:
        assert got.predicted_labels is None and ref.predicted_labels is None
        np.testing.assert_array_equal(got.centroids, ref.centroids)
        np.testing.assert_array_equal(got.aabbs, ref.aabbs)


@pytest.mark.parametrize("k", [2, 8, 16])
def test_kmeans_matches_sklearn(k):
    for seed in range(6):
        rng = np.random.RandomState(seed)
        n = rng.randint(3 * k, 400)
        pts = (rng.randn(n, 3) * [60.0, 90.0, 2.0] + rng.randn(1, 3) * 500).astype(np.float32)
        if seed % 2:  # clusters with duplicated points
            pts = np.concatenate([pts[: n // 2], pts[: n // 2] + 40.0]).astype(np.float32)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            km = KMeans(n_clusters=k, random_state=0, n_init="auto", max_iter=500).fit(pts)
        centers, labels = TP.kmeans(pts, k)
        np.testing.assert_array_equal(labels, km.predict(pts), err_msg=f"seed {seed}")
        np.testing.assert_allclose(centers, km.cluster_centers_, rtol=1e-5, atol=1e-4,
                                   err_msg=f"seed {seed}")
