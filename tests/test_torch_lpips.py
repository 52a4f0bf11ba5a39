"""The port's LPIPS (presight_tpu_torch/utils/lpips.py), its scorer
(utils/metrics.lpips_fn) and the PNG writer (utils/png.py), on the CPU.

  * LPIPS against the JAX package's on the same random weights, written in
    the official state_dict layout from a numpy seed: two pairs of 32x48
    images within rtol 1e-5 (measured gap ~1e-6: the same f32 sums in other
    orders; a TF32-sized error, ~1e-4 on the card, fails it);
  * both loader layouts (official ``lpips``, torchmetrics' ``net.``-prefixed)
    give exactly the JAX loader's parameters, and both loaders refuse a
    state_dict without the five heads;
  * ``lpips_fn``: an ``.npz`` and a ``.pt`` of the same weights score
    alike, and a file that cannot be loaded raises;
  * the PNG writer's two modes, greyscale and RGB: Pillow decodes each file
    to exactly the array written.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from presight_tpu.utils import lpips as JL
from presight_tpu_torch.utils import lpips as TL
from presight_tpu_torch.utils import metrics as TM
from presight_tpu_torch.utils.png import write_png
from test_torch_cuda import lpips_state_dict


def _pairs(seed, n=2, shape=(32, 48, 3)):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        a = rng.rand(*shape).astype(np.float32)
        out.append((a, np.clip(a + 0.1 * rng.randn(*shape), 0, 1).astype(np.float32)))
    return out


def test_lpips_matches_jax():
    state = lpips_state_dict(0)
    jp, tp = JL.load_torch_state_dict(state), TL.load_torch_state_dict(state)
    jitted = jax.jit(lambda a, b: JL.lpips(jp, a, b))
    for a, b in _pairs(1):
        want = float(jitted(jnp.asarray(a), jnp.asarray(b)))
        got = float(TL.lpips(tp, torch.from_numpy(a), torch.from_numpy(b)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    a, b = _pairs(2, n=1)[0]
    assert float(TL.lpips(tp, torch.from_numpy(a), torch.from_numpy(a))) < 1e-9
    one = float(TL.lpips(tp, torch.from_numpy(a), torch.from_numpy(b)))
    batch = TL.lpips(tp, torch.from_numpy(np.stack([a, b])), torch.from_numpy(np.stack([b, a])))
    np.testing.assert_allclose(float(batch), one, rtol=1e-5)


@pytest.mark.parametrize("prefix", ["", "net."], ids=["lpips", "torchmetrics"])
def test_loader_layouts_match_jax(prefix):
    state = lpips_state_dict(3, prefix)
    jp, tp = JL.load_torch_state_dict(state), TL.load_torch_state_dict(state)
    assert len(tp["convs"]) == len(jp["convs"]) == len(TL.conv_channel_plan())
    for t, j, (c_in, c_out) in zip(tp["convs"], jp["convs"], TL.conv_channel_plan()):
        assert tuple(t["w"].shape) == (c_out, c_in, 3, 3)
        np.testing.assert_array_equal(t["w"].numpy(), np.asarray(j["w"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(t["b"].numpy(), np.asarray(j["b"]))
    for t, j in zip(tp["lins"], jp["lins"], strict=True):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_loaders_refuse_other_layouts():
    state = {k: v for k, v in lpips_state_dict(4).items() if not k.startswith("lin4.")}
    for loader in (JL.load_torch_state_dict, TL.load_torch_state_dict):
        with pytest.raises(ValueError, match="unrecognized LPIPS state_dict"):
            loader(state)


def test_random_weights_have_the_jax_shapes():
    tp = TL.random_weights(torch.Generator().manual_seed(0))
    jp = jax.eval_shape(JL.random_weights, jax.random.PRNGKey(0))
    assert TL.conv_channel_plan() == JL.conv_channel_plan()
    for t, j in zip(tp["convs"], jp["convs"], strict=True):
        assert tuple(t["w"].permute(2, 3, 1, 0).shape) == j["w"].shape
        assert t["b"].shape == j["b"].shape
    assert [t.shape for t in tp["lins"]] == [j.shape for j in jp["lins"]]
    assert all(bool((t >= 0).all()) for t in tp["lins"])


def test_lpips_fn_npz_and_pt_agree(tmp_path, monkeypatch):
    state = lpips_state_dict(5)
    np.savez(tmp_path / "w.npz", **state)
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, tmp_path / "w.pt")
    (a, b), = _pairs(6, n=1)
    monkeypatch.setattr(TM, "_LPIPS_CACHE", {})
    scores = []
    for name in ("w.npz", "w.pt"):
        monkeypatch.setenv("PRESIGHT_LPIPS_WEIGHTS", str(tmp_path / name))
        fn = TM.lpips_fn("cpu")
        assert fn is TM.lpips_fn("cpu")  # loaded once
        scores.append(fn(a, b))
    assert scores[0] == scores[1]
    params = TL.load_torch_state_dict(state)
    assert scores[0] == float(TL.lpips(params, torch.from_numpy(a), torch.from_numpy(b)))


@pytest.mark.parametrize("name,content", [
    ("bad.npz", b"not an npz file"),
    ("bad.pt", b"not a torch file"),
    ("heads.npz", None),  # a readable file without the lin heads
])
def test_lpips_fn_raises_on_a_malformed_file(tmp_path, monkeypatch, name, content):
    path = tmp_path / name
    if content is None:
        np.savez(path, **{k: v for k, v in lpips_state_dict(7).items() if "lin" not in k})
    else:
        path.write_bytes(content)
    monkeypatch.setattr(TM, "_LPIPS_CACHE", {})
    monkeypatch.setenv("PRESIGHT_LPIPS_WEIGHTS", str(path))
    with pytest.raises(Exception) as info:
        TM.lpips_fn("cpu")
    assert any("PRESIGHT_LPIPS_WEIGHTS" in note for note in info.value.__notes__)
    assert TM._LPIPS_CACHE == {}  # nothing cached: the next call raises too


@pytest.mark.parametrize("shape", [(1, 1), (17, 31), (24, 40, 3), (5, 300, 3)])
def test_png_writer_decodes_to_the_array_written(tmp_path, shape):
    image = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.uint8)
    write_png(tmp_path / "x.png", image)
    with Image.open(tmp_path / "x.png") as im:
        assert im.mode == ("L" if len(shape) == 2 else "RGB")
        np.testing.assert_array_equal(np.asarray(im), image)


@pytest.mark.parametrize("image", [np.zeros((4, 4), np.float32), np.zeros((4, 4, 4), np.uint8),
                                   np.zeros((4,), np.uint8)], ids=["float", "rgba", "1d"])
def test_png_writer_refuses_other_images(tmp_path, image):
    with pytest.raises(ValueError, match="uint8"):
        write_png(tmp_path / "x.png", image)
