"""The port's serving CLIs (presight_tpu_torch/scripts/{extract_priors,
eval,render,export}.py) against the JAX package's, on the CPU.

The JAX train CLI trains synthetic-demo for two steps on a 24x40 fixture;
``_port_run`` carries its weights into a port run directory (the JAX
eval_setup restores them, bridge.from_jax_params converts them, the port's
save_checkpoint writes them beside the JAX-written config.yml). Each CLI
then runs in both packages on its run directory:

  * extract_priors (density threshold 0, so the pickle is not empty): the
    same keys, dtypes and shapes, identical voxel count, hits and origin;
    points, features and colours at test_torch_slice.py's
    test_extraction_matches_jax tolerances (points rtol 1e-6 + atol 2e-5,
    f16 features atol 2e-3, colours rtol 1e-5 + atol 1e-4);
  * eval with LPIPS from random weights ($PRESIGHT_LPIPS_WEIGHTS): the same
    keys; psnr and lpips within rtol 1e-5, ssim within rtol 5e-5: the
    measured ssim gap is 1.8e-5, because the JAX package computes SSIM in
    float32, whose variances (E[x^2] - E[x]^2) cancel on smooth renders,
    and the port in float64;
  * render at --downscale 2: the same file names; every PNG pixel within 1
    of JAX's (a value near a multiple of 1/255 may truncate to either
    side); the share that differ is printed. RGB and DINO PNGs are equal;
    the depth PNGs differ by 1 at 2.5% and 36% of pixels: after two steps
    the depth is nearly flat, and the min/max normalisation scales the
    renders' f32 gap by 255 over that small range;
  * export cameras: the same JSON within 1e-6;
  * export pointcloud: the same vertex count, coordinates within 2e-3 (the
    PLY's three decimals) and colours within 1;
  * --num-devices 2 raises NotImplementedError in each CLI that has it.
"""

import json
import shutil

import jax
import numpy as np
import pickle
import pytest
import torch
from PIL import Image

from presight_tpu.data.synthetic import generate_scene as jax_generate_scene
from presight_tpu.engine.trainer import eval_setup as jax_eval_setup
from presight_tpu.scripts import eval as jax_eval
from presight_tpu.scripts import export as jax_export
from presight_tpu.scripts import extract_priors as jax_extract
from presight_tpu.scripts import render as jax_render
from presight_tpu.scripts import train as jax_train
from presight_tpu.utils import metrics as JM
from presight_tpu_torch import bridge
from presight_tpu_torch.engine import trainer as TT
from presight_tpu_torch.engine.checkpoints import save_checkpoint
from presight_tpu_torch.scripts import eval as port_eval
from presight_tpu_torch.scripts import export as port_export
from presight_tpu_torch.scripts import extract_priors as port_extract
from presight_tpu_torch.scripts import render as port_render
from presight_tpu_torch.utils import metrics as TM
from test_torch_cuda import lpips_state_dict


def _copy_tree(dst, src):
    """Copy the tree ``src`` into the model's parameters ``dst``, matched by
    key and position (JAX trees keep their dicts in sorted key order, the
    port's model in its own)."""
    if isinstance(dst, dict):
        assert set(dst) == set(src)
        for k in dst:
            _copy_tree(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for a, b in zip(dst, src, strict=True):
            _copy_tree(a, b)
    else:
        assert dst.shape == src.shape
        dst.copy_(src)


@torch.no_grad()
def _port_run(jax_run, dest):
    """The JAX run's weights, restored by the JAX eval_setup, as a port
    checkpoint in ``dest`` beside a copy of the JAX-written config.yml."""
    _, jt = jax_eval_setup(jax_run / "config.yml")
    params = jax.tree_util.tree_map(np.asarray, jt.state.params)
    dest.mkdir()
    shutil.copy(jax_run / "config.yml", dest / "config.yml")
    _, pt = TT.eval_setup(dest / "config.yml", device="cpu")
    try:
        _copy_tree(pt.model.params(), bridge.from_jax_params(params))
        save_checkpoint(dest, jt.start_step, pt.model, pt.optimizers)
    finally:
        pt.close()
    return dest


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX run dir, port run dir) of the same two-step synthetic-demo run."""
    root = tmp_path_factory.mktemp("serve")
    scene = jax_generate_scene(root / "nusc", num_frames=2, height=24, width=40)
    argv = ["synthetic-demo", "--pipeline.dataparser.data-dir", str(scene),
            "--pipeline.dataparser.centroids-dir", str(scene / "centroids"),
            "--output-dir", str(root / "out"), "--timestamp", "t", "--max-num-iterations", "2",
            "--pipeline.datamanager.train-num-rays-per-batch", "64",
            "--pipeline.model.eval-num-rays-per-chunk", "1024",
            "--steps-per-eval-batch", "0", "--steps-per-eval-image", "0", "--eval-lpips", "false"]
    assert jax_train.main(argv) == 0
    jax_run = root / "out" / "synthetic-demo" / "synthetic-demo" / "t"
    return jax_run, _port_run(jax_run, root / "port_run")


def _both(jax_main, port_main, argv_of, tmp_path, runs):
    """Run a CLI of each package; argv_of(run_dir, out_dir) -> argv.
    Returns (JAX out dir, port out dir)."""
    outs = []
    for main, run, name, kw in ((jax_main, runs[0], "jax", {}),
                                (port_main, runs[1], "port", {"device": "cpu"})):
        out = tmp_path / name
        assert main(argv_of(run, out), **kw) == 0
        outs.append(out)
    return outs


def test_extract_priors_cli_matches_jax(runs, tmp_path):
    ref_dir, out_dir = _both(
        jax_extract.main, port_extract.main,
        lambda run, out: [str(run), "--downscale", "1", "--density-threshold", "0",
                          "--output-dir", str(out)],
        tmp_path, runs)
    with open(ref_dir / "extracted_priors.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(out_dir / "extracted_priors.pkl", "rb") as f:
        out = pickle.load(f)
    assert set(out) == set(ref) == {"points", "features", "colors", "hits", "origin"}
    for key in ref:
        assert out[key].dtype == ref[key].dtype and out[key].shape == ref[key].shape, key
    assert len(out["points"]) > 0
    np.testing.assert_array_equal(out["hits"], ref["hits"])
    np.testing.assert_array_equal(out["origin"], ref["origin"])
    np.testing.assert_allclose(out["points"], ref["points"], rtol=1e-6, atol=2e-5)
    np.testing.assert_allclose(out["colors"], ref["colors"], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(out["features"].astype(np.float32),
                               ref["features"].astype(np.float32), atol=2e-3)
    assert (out_dir / "priors_for_vis.ply").exists() and (ref_dir / "priors_for_vis.ply").exists()


def test_eval_cli_matches_jax(runs, tmp_path, monkeypatch):
    np.savez(tmp_path / "lpips.npz", **lpips_state_dict(0))
    monkeypatch.setenv("PRESIGHT_LPIPS_WEIGHTS", str(tmp_path / "lpips.npz"))
    monkeypatch.setattr(JM, "_LPIPS_CACHE", {})
    monkeypatch.setattr(TM, "_LPIPS_CACHE", {})
    ref_dir, out_dir = _both(
        jax_eval.main, port_eval.main,
        lambda run, out: [str(run), "--max-images", "2", "--output-path", str(out)],
        tmp_path, runs)
    ref, out = json.loads(ref_dir.read_text()), json.loads(out_dir.read_text())
    assert set(out) == set(ref) == {"psnr", "ssim", "lpips"}
    for key, rtol in (("psnr", 1e-5), ("ssim", 5e-5), ("lpips", 1e-5)):
        np.testing.assert_allclose(out[key], ref[key], rtol=rtol, err_msg=key)


def test_render_cli_matches_jax(runs, tmp_path, capsys):
    ref_dir, out_dir = _both(
        jax_render.main, port_render.main,
        lambda run, out: [str(run), "--output-dir", str(out), "--indices", "0", "3",
                          "--downscale", "2"],
        tmp_path, runs)
    names = sorted(p.name for p in ref_dir.iterdir())
    assert sorted(p.name for p in out_dir.iterdir()) == names
    assert len(names) == 6  # rgb, depth and dino of two cameras
    with capsys.disabled():
        for name in names:
            with Image.open(ref_dir / name) as a, Image.open(out_dir / name) as b:
                assert a.mode == b.mode and a.size == b.size == (20, 12)
                diff = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
            print(f"\n  {name}: {float((diff > 0).mean()):.4f} of the values differ, by at "
                  f"most {int(diff.max())}")
            assert diff.max() <= 1, name


def test_export_cameras_cli_matches_jax(runs, tmp_path):
    ref_dir, out_dir = _both(
        jax_export.main, port_export.main,
        lambda run, out: ["cameras", str(run), "--output-dir", str(out)], tmp_path, runs)
    ref = json.loads((ref_dir / "camera_poses.json").read_text())["frames"]
    out = json.loads((out_dir / "camera_poses.json").read_text())["frames"]
    assert len(out) == len(ref) > 0
    for a, b in zip(out, ref):
        assert set(a) == set(b)
        for key in b:
            np.testing.assert_allclose(a[key], b[key], atol=1e-6, err_msg=key)


def _read_ply(path):
    lines = path.read_text().splitlines()
    n = int(next(line for line in lines if line.startswith("element vertex")).split()[-1])
    body = lines[lines.index("end_header") + 1:]
    assert len(body) == n
    return np.array([[float(v) for v in line.split()] for line in body]).reshape(n, 6)


def test_export_pointcloud_cli_matches_jax(runs, tmp_path):
    ref_dir, out_dir = _both(
        jax_export.main, port_export.main,
        lambda run, out: ["pointcloud", str(run), "--output-dir", str(out), "--num-points",
                          "500", "--nb-points", "5"],
        tmp_path, runs)
    ref, out = _read_ply(ref_dir / "point_cloud.ply"), _read_ply(out_dir / "point_cloud.ply")
    assert len(out) == len(ref) > 0
    np.testing.assert_allclose(out[:, :3], ref[:, :3], atol=2e-3)
    assert np.abs(out[:, 3:] - ref[:, 3:]).max() <= 1


def test_export_mesh_subcommands_report_out_of_scope(runs):
    with pytest.raises(SystemExit):
        port_export.main(["poisson", str(runs[1])], device="cpu")


@pytest.mark.parametrize("cli", [port_extract, port_eval, port_render],
                         ids=["extract_priors", "eval", "render"])
def test_num_devices_other_than_one_raises(runs, tmp_path, cli):
    argv = [str(runs[1]), "--num-devices", "2"]
    if cli is port_render:
        argv += ["--output-dir", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        cli.main(argv, device="cpu")
