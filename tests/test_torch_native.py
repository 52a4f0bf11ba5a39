"""The port's native voxel accumulator (presight_tpu_torch.native, built with
g++ into build/native/) against its plain numpy version
(prior/voxelize.StreamingVoxelAccumulator, which runs inside
``kernels.plain_versions()``): the same bytes, on the points of the
synthetic fixture that test_torch_slice.py's extraction test uses, and the
library is built outside the source tree, keyed on the source."""

import contextlib
import pickle
import re

import numpy as np

from presight_tpu_torch import kernels, native
from presight_tpu_torch.prior.voxelize import StreamingVoxelAccumulator, make_streaming_accumulator


def test_native_library_builds_into_build_dir():
    path = native.build()
    assert path.parent == native.BUILD_DIR
    assert re.fullmatch(r"libvoxelize_[0-9a-f]{16}\.so", path.name)
    assert not list(native.SOURCE.parent.glob("*.so"))


def test_native_accumulator_matches_numpy_bytes():
    rng = np.random.RandomState(0)
    points = rng.randn(5000, 3) * 10
    colors = rng.rand(5000, 3).astype(np.float32)
    feats = rng.rand(5000, 16).astype(np.float16)
    min_bound = points.min(axis=0) - 1.0
    outs = []
    for scope in (contextlib.nullcontext(), kernels.plain_versions()):
        with scope:
            acc = make_streaming_accumulator(0.4, min_bound, feature_dim=16)
        acc.add(points[:3000], colors[:3000], feats[:3000])
        acc.add(points[3000:], colors[3000:], feats[3000:])
        outs.append(acc.finalize())
    assert isinstance(make_streaming_accumulator(0.4, min_bound), native.VoxelAccumulator)
    with kernels.plain_versions():
        assert isinstance(make_streaming_accumulator(0.4, min_bound), StreamingVoxelAccumulator)
    for key in outs[1]:
        assert outs[0][key].dtype == outs[1][key].dtype, key
        assert outs[0][key].tobytes() == outs[1][key].tobytes(), key


def test_extraction_pickle_is_the_same_with_either_accumulator(tmp_path):
    """extract_voxels on the synthetic fixture of test_extraction_matches_jax,
    once with each accumulator (the numpy one inside
    ``kernels.plain_versions()``): the pickles are byte-identical."""
    from presight_tpu.data.dataparser import DataParserConfig, make_camera_params, parse
    from presight_tpu.data.synthetic import generate_scene
    from presight_tpu_torch.data import cameras as TC
    from presight_tpu_torch.prior.extraction import extract_voxels
    from test_torch_slice import _models, _t

    scene_dir = generate_scene(tmp_path / "nusc", num_frames=2, height=24, width=40)
    parsed = parse(DataParserConfig(data_dir=scene_dir, location="synthetic-city", num_aabbs=2,
                                    pose_scale_factor=0.05, depth_type="lidar",
                                    centroids_dir=scene_dir / "centroids"), split="train")
    _, _, model = _models(parsed.aabbs, parsed.centroids, len(parsed.items), parsed.num_videos)
    jcams = make_camera_params(parsed.items)
    tcams = TC.CameraParams(**{k: _t(getattr(jcams, k))
                               for k in ("c2w", "fx", "fy", "cx", "cy", "video_ids")})
    blobs = []
    for name, scope in (("native", contextlib.nullcontext()),
                        ("numpy", kernels.plain_versions())):
        out = tmp_path / name
        with scope:
            extract_voxels(model, parsed.items, tcams, pose_scale_factor=parsed.pose_scale_factor,
                           origin=parsed.pose_transformation, dino_to_rgb=parsed.dino_to_rgb,
                           output_dir=out, density_threshold=0.0)
        blobs.append((out / "extracted_priors.pkl").read_bytes())
    assert len(pickle.loads(blobs[0])["points"]) > 0
    assert blobs[0] == blobs[1]
