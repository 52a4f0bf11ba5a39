"""The port's chunked dataset, data manager and device stores against the
JAX package's, on the JAX package's synthetic fixture: the same numpy
streams give the same chunks and batches, bit for bit, and the device
stores (here on the CPU device) hand out the host path's rows.
"""

import numpy as np
import pytest
import torch

from presight_tpu.data import dataparser as JP
from presight_tpu.data.datamanager import DataManager as JDataManager
from presight_tpu.data.dataset import PixelChunkDataset as JDataset
from presight_tpu.data.synthetic import generate_scene as jax_generate_scene
from presight_tpu_torch import configs as TC
from presight_tpu_torch.data import dataparser as TP
from presight_tpu_torch.data.datamanager import DataManager
from presight_tpu_torch.data.dataset import PixelChunkDataset
from presight_tpu_torch.data.device_store import ChunkDeviceStore, DeviceRayStore

BATCH = 600
CHUNK = dict(images_per_chunk=4, chunk_ratio=0.2, num_threads=2)


@pytest.fixture(scope="module")
def parsed(tmp_path_factory):
    root = jax_generate_scene(tmp_path_factory.mktemp("synthetic"))
    kw = dict(data_dir=root, location="synthetic-city", num_aabbs=2, depth_type="lidar",
              centroids_dir=root / "centroids", train_split_fraction=0.9)
    return JP.parse(JP.DataParserConfig(**kw)), TP.parse(TC.DataParserConfig(**kw))


def _labels(out):
    train = np.nonzero([not it.is_val for it in out.all_items])[0]
    return out.predicted_labels[train]


def _managers(parsed, load_features, chunk_store=None, seed=42):
    jout, tout = parsed
    jds = JDataset(jout.items, _labels(jout), load_features=load_features, **CHUNK)
    tds = PixelChunkDataset(tout.items, _labels(tout), load_features=load_features, **CHUNK)
    return (JDataManager(jds, BATCH, seed=seed),
            DataManager(tds, BATCH, seed=seed, chunk_store=chunk_store))


@pytest.mark.parametrize("load_features", [True, False], ids=["features", "no-features"])
def test_chunks_and_batches_match_jax(parsed, load_features):
    jdm, tdm = _managers(parsed, load_features)
    try:
        for step in (42, 43):
            ref, got = jdm.dataset.load_chunk(step), tdm.dataset.load_chunk(step)
            assert sorted(got.data) == sorted(ref.data)
            for k in ref.data:
                assert got.data[k].dtype == ref.data[k].dtype, k
                np.testing.assert_array_equal(got.data[k], ref.data[k], err_msg=k)
        chunks = set()
        for _ in range(5):
            ref, got = jdm.next_batch(), tdm.next_batch()
            chunks.add(tdm._chunk_id)
            assert sorted(got) == sorted(ref)
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert len(chunks) >= 2
    finally:
        jdm.close()
        tdm.close()


def test_device_ray_store_gathers_host_rows(parsed):
    _, tout = parsed
    store = DeviceRayStore.maybe_build(tout.items, True, cap_mb=512, device="cpu")
    assert store is not None and store.features.dtype == torch.float32
    assert DeviceRayStore.maybe_build(tout.items, True, cap_mb=512, device="cpu") is store
    assert DeviceRayStore.maybe_build(tout.items, True, cap_mb=1, device="cpu") is None
    _, tdm = _managers(parsed, True)
    try:
        for _ in range(3):
            host = tdm.next_batch()
            dev = store.batch(host["ray_index"], with_features=True)
            for k in ("ray_index", "rgb", "sky", "depth", "features"):
                np.testing.assert_array_equal(dev[k].numpy(), host[k], err_msg=k)
    finally:
        tdm.close()


def test_chunk_store_batches_equal_host_rows(parsed):
    store = ChunkDeviceStore(cap_mb=64, device="cpu")
    _, host_dm = _managers(parsed, True)
    _, dev_dm = _managers(parsed, True, chunk_store=store)
    try:
        for _ in range(5):
            host, dev = host_dm.next_batch(), dev_dm.next_batch()
            assert isinstance(dev["rgb"], torch.Tensor)
            assert sorted(dev) == sorted(host)
            for k in host:
                np.testing.assert_array_equal(dev[k].numpy(), host[k], err_msg=k)
            assert len(store._staged) <= 2
        n = len(dev_dm._chunk)
        rows = store._staged[dev_dm._chunk_id][0]["rgb"].shape[0]
        assert rows >= n and rows % (1 << 16) == 0 and (rows // (1 << 16)) & (rows // (1 << 16) - 1) == 0
    finally:
        host_dm.close()
        dev_dm.close()


def test_chunk_store_over_cap_gives_host_values(parsed):
    store = ChunkDeviceStore(cap_mb=1, device="cpu")
    _, dm = _managers(parsed, True, chunk_store=store)
    try:
        batch = dm.next_batch()
        assert isinstance(batch["rgb"], np.ndarray) and not store.enabled
        assert not store._staged
    finally:
        dm.close()


def test_generate_scene_matches_jax(tmp_path):
    """The port's fixture writer gives the JAX package's fixture: the same
    files, byte for byte (its JPEGs from the port's encoder), and the same
    sample_data records up to the root directory in their paths."""
    import filecmp
    import pickle

    from presight_tpu_torch.data.synthetic import generate_scene

    ref, got = jax_generate_scene(tmp_path / "jax"), generate_scene(tmp_path / "port")
    ref_files = sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    assert ref_files == sorted(p.relative_to(got) for p in got.rglob("*") if p.is_file())
    assert any(p.suffix == ".jpg" for p in ref_files)
    for rel in ref_files:
        if rel.parts[0] != "PreSight":
            assert filecmp.cmp(ref / rel, got / rel, shallow=False), rel
            continue
        with open(ref / rel, "rb") as a, open(got / rel, "rb") as b:
            for x, y in zip(pickle.load(a), pickle.load(b), strict=True):
                assert x.keys() == y.keys()
                for k in x:
                    if isinstance(x[k], str):
                        assert x[k].replace(str(ref), "") == y[k].replace(str(got), ""), k
                    else:
                        np.testing.assert_array_equal(x[k], y[k], err_msg=k)
