"""The port's occupancy CLI (presight_tpu_torch/scripts/train_occ.py
--eval-ckpt) against the JAX package's, on the CPU.

The JAX train_occ trains its default toy model (stereo off) for 2
iterations and pickles the checkpoint; both CLIs evaluate it on the toy
batches of the same seed (numpy RandomState, so the same arrays), with the
EMA and the raw weights, and on an .npz directory with camera masks: the
printed per-class IoU and mIoU lines must be equal, and the predicted
classes of every voxel too. The pickle loads in a hermetic interpreter
with jax and flax blocked (it holds numpy arrays only). What the port's
CLI does not serve yet (--infos / --prior-root, --bf16) raises SystemExit
naming the ROADMAP item. Training is tested in test_torch_occ_train_cli.py.
"""

import argparse
import contextlib
import io
import os
import pickle
import subprocess
import sys
import sysconfig
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presight_tpu.occupancy import BEVDetOcc as JaxBEVDetOcc
from presight_tpu.scripts import train_occ as jax_cli
from presight_tpu_torch import bridge
from presight_tpu_torch.occupancy import BEVDetOcc
from presight_tpu_torch.scripts import train_occ as port_cli

REPO = Path(__file__).resolve().parents[1]


def _lines(main, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv, **kw) == 0
    return [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("class ") or ln.startswith("mIoU")]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    out = tmp_path_factory.mktemp("occ")
    assert jax_cli.main(["--iters", "2", "--out", str(out)]) == 0
    return out / "occ-step-000000002.pkl"


@pytest.mark.parametrize("params", ["ema", "raw"])
def test_eval_lines_match_jax_cli(checkpoint, params):
    argv = ["--eval-ckpt", str(checkpoint), "--eval-params", params]
    want = _lines(jax_cli.main, argv)
    got = _lines(port_cli.main, argv, device="cpu")
    assert len(got) == 19 and got == want
    assert got[-1].endswith(f"over 4 batches ({params} weights)")


def test_predicted_classes_match_jax(checkpoint):
    """Every voxel's class on the four toy batches, not only the metric."""
    with open(checkpoint, "rb") as f:
        variables = pickle.load(f)["params"]
    cfg = port_cli.build_config(argparse.Namespace(
        config=None, temporal=False, backbone="simple", resnet_base_width=8, bev_neck="simple"))
    model = BEVDetOcc(cfg, device="cpu")
    bridge.occ_state_from_flax(variables, model)
    ref = JaxBEVDetOcc(grid_config=cfg.grid_config, input_size=cfg.input_size,
                       downsample=16, view_out_channels=16, img_widths=(8, 16, 16, 32),
                       neck_channels=32, bev_widths=(16, 32), bev_out_channels=16,
                       occ_out_dim=16, num_classes=18)
    apply = jax.jit(lambda v, *a: ref.apply(v, *a)[0])
    for i in range(4):
        b = port_cli.toy_batch(i)
        args = [b[k] for k in port_cli._MODEL_INPUTS]
        want = np.asarray(jnp.argmax(apply(variables, *args), -1))
        with torch.no_grad():
            got = model(*map(torch.as_tensor, args))[0].argmax(-1).numpy()
        np.testing.assert_array_equal(got, want)
        jb = jax_cli.toy_batch(i)
        for k in b:
            np.testing.assert_array_equal(b[k], np.asarray(jb[k]))


def test_eval_on_npz_dir_with_camera_masks(checkpoint, tmp_path):
    rng = np.random.RandomState(4)
    for i in range(2):
        b = port_cli.toy_batch(10 + i)
        b["mask_camera"] = (rng.rand(*b["voxel_semantics"].shape) > 0.3).astype(np.uint8)
        np.savez(tmp_path / f"sample_{i}.npz", **b)
    argv = ["--eval-ckpt", str(checkpoint), "--data-dir", str(tmp_path)]
    got = _lines(port_cli.main, argv, device="cpu")
    assert got == _lines(jax_cli.main, argv)
    assert got[-1].endswith("over 2 batches (ema weights)")


def test_checkpoint_unpickles_without_jax(checkpoint):
    code = (
        "import pickle, sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'presight_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"d = pickle.load(open({str(checkpoint)!r}, 'rb'))\n"
        "import numpy as np\n"
        "leaves = []\n"
        "def walk(t):\n"
        "    for v in t.values():\n"
        "        walk(v) if isinstance(v, dict) else leaves.append(type(v).__module__)\n"
        "walk(d['params']); walk(d['ema'])\n"
        "print('OK', sorted(set(leaves)), d['ema_updates'], d['iters'])\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = sysconfig.get_paths()["purelib"] + os.pathsep + str(REPO)
    proc = subprocess.run([sys.executable, "-S", "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split("\n")[0] == "OK ['numpy'] 2 2"


@pytest.mark.parametrize("argv,what", [
    (["--eval-ckpt", "x.pkl", "--infos", "infos.pkl"], "stage3_pipeline"),
    (["--eval-ckpt", "x.pkl", "--prior-root", "priors"], "stage3_pipeline"),
    (["--eval-ckpt", "x.pkl", "--bf16"], "deploy"),
])
def test_unported_options_exit_naming_the_roadmap(argv, what):
    with pytest.raises(SystemExit, match=f"{what}.*ROADMAP|ROADMAP.*{what}"):
        port_cli.main(argv, device="cpu")
