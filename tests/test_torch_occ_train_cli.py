"""The port's occupancy training CLI (presight_tpu_torch/scripts/train_occ.py
without --eval-ckpt) against the JAX package's, on the CPU.

The port trains its toy model for 12 iterations (main(argv, device="cpu"));
the JAX CLI trains its own for 2. Their pickles must have one tree: the
same keys, leaf names, shapes and numpy dtypes under "params" and "ema",
and ints for "ema_updates" and "iters". The JAX CLI's --eval-ckpt reads
the port-trained pickle and prints the per-class IoU and mIoU lines that
the port's --eval-ckpt prints on it, with the EMA and the raw weights, on
the toy batches and on an .npz directory with camera masks (a temporal
model trained there). The printed lines follow the JAX CLI's format, the
loss falls, --ema-init-updates seeds the EMA's counter, and the CLI runs
on the card unless told otherwise.
"""

import contextlib
import io
import pickle
import re

import numpy as np
import pytest
import torch

from presight_tpu.scripts import train_occ as jax_cli
from presight_tpu_torch.scripts import train_occ as port_cli


def _run(main, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv, **kw) == 0
    return buf.getvalue().splitlines()


def _eval_lines(lines):
    return [ln for ln in lines if ln.startswith("class ") or ln.startswith("mIoU")]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("occ_train")
    port_lines = _run(port_cli.main, ["--iters", "12", "--out", str(out / "port")],
                      device="cpu")
    _run(jax_cli.main, ["--iters", "2", "--out", str(out / "jax")])
    return dict(lines=port_lines, port=out / "port" / "occ-step-000000012.pkl",
                jax=out / "jax" / "occ-step-000000002.pkl")


def test_training_prints_the_jax_cli_lines_and_the_loss_falls(trained):
    lines = trained["lines"]
    iters = [re.fullmatch(r"iter +(\d+) \| loss=(\d+\.\d{4}) \| \d+\.\ds", ln) for ln in lines[:-1]]
    assert all(iters), lines
    assert [int(m.group(1)) for m in iters] == [0, 10, 11]
    losses = [float(m.group(2)) for m in iters]
    assert losses[-1] < losses[0]
    assert lines[-1] == f"saved {trained['port']} (final loss {losses[-1]:.4f})"


def _tree(t):
    if isinstance(t, dict):
        return {k: _tree(v) for k, v in t.items()}
    return (type(t).__name__, t.shape, t.dtype.str)


def test_pickle_has_the_jax_cli_tree(trained):
    with open(trained["port"], "rb") as f:
        port = pickle.load(f)
    with open(trained["jax"], "rb") as f:
        ref = pickle.load(f)
    assert sorted(port) == sorted(ref) == ["ema", "ema_updates", "iters", "params"]
    assert _tree(port["params"]) == _tree(ref["params"])
    assert _tree(port["ema"]) == _tree(ref["ema"]) == _tree(ref["params"])
    assert type(port["ema_updates"]) is type(ref["ema_updates"]) is int
    assert type(port["iters"]) is type(ref["iters"]) is int
    assert port["ema_updates"] == port["iters"] == 12
    # the EMA lags the weights it follows
    assert not np.array_equal(port["ema"]["params"]["OccHead_0"]["Dense_1"]["kernel"],
                              port["params"]["params"]["OccHead_0"]["Dense_1"]["kernel"])


@pytest.mark.parametrize("params", ["ema", "raw"])
def test_jax_cli_evaluates_a_port_trained_pickle(trained, params):
    argv = ["--eval-ckpt", str(trained["port"]), "--eval-params", params]
    want = _eval_lines(_run(port_cli.main, argv, device="cpu"))
    got = _eval_lines(_run(jax_cli.main, argv))
    assert len(want) == 19 and got == want
    assert want[-1].endswith(f"over 4 batches ({params} weights)")


def test_temporal_training_on_masked_npz_samples(tmp_path):
    """--temporal from an .npz directory with camera masks (occ_loss's
    masked mean); both CLIs evaluate the result alike."""
    rng = np.random.RandomState(7)
    data = tmp_path / "npz"
    data.mkdir()
    for i in range(2):
        b = port_cli.toy_batch(20 + i)
        b["mask_camera"] = (rng.rand(*b["voxel_semantics"].shape) > 0.3).astype(np.uint8)
        np.savez(data / f"sample_{i}.npz", **b)
    out = tmp_path / "out"
    lines = _run(port_cli.main, ["--temporal", "--data-dir", str(data), "--iters", "3",
                                 "--out", str(out)], device="cpu")
    assert lines[-1].startswith(f"saved {out / 'occ-step-000000003.pkl'}")
    with open(out / "occ-step-000000003.pkl", "rb") as f:
        assert "temporal_fuse" in pickle.load(f)["params"]["params"]
    argv = ["--temporal", "--data-dir", str(data), "--eval-ckpt",
            str(out / "occ-step-000000003.pkl")]
    want = _eval_lines(_run(port_cli.main, argv, device="cpu"))
    assert _eval_lines(_run(jax_cli.main, argv)) == want
    assert want[-1].endswith("over 2 batches (ema weights)")


def test_ema_init_updates_seed_the_counter(tmp_path):
    _run(port_cli.main, ["--iters", "2", "--ema-init-updates", "10560", "--out", str(tmp_path)],
         device="cpu")
    with open(tmp_path / "occ-step-000000002.pkl", "rb") as f:
        ckpt = pickle.load(f)
    assert ckpt["ema_updates"] == 10562 and ckpt["iters"] == 2


def test_cli_trains_on_the_card_by_default(tmp_path):
    """Without ``device`` the CLI builds its model on 'cuda': here, where
    torch has no CUDA, that raises before any step."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would train on it")
    with pytest.raises((RuntimeError, AssertionError), match="CUDA|cuda"):
        port_cli.main(["--iters", "1", "--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())
