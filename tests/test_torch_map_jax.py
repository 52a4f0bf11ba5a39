"""The online-mapping port against the JAX package's StreamMapNet on the
CPU, through ``bridge.map_state_from_flax``: smn-toy (the strided-conv
stand-in, 2 encoder and 2 decoder layers) with a prior range added, so
PriorFusion2D runs too, over two streaming frames with priors (300
distinct voxels of a 60 x 30 x 8 grid), the second from the first's BEV
and top-k hand-off with an ego motion that rotates; one ``apply`` per frame
in a module fixture, jitted: eager, the CPU compiles each op apart (~37 s
for the two frames, against ~7 s jitted).

The flax variables are drawn in numpy at the shapes ``init`` gives
(``jax.eval_shape``): LeCun-normal kernels, biases, scales and BatchNorm
statistics at random, and the sampling-offset biases N(0, 1), so every
deformable tap falls between pixel centres. Tolerance: within 1e-5 of each
output's largest value (sums in other orders; measured ~3e-7).

The bridge leaf for leaf: every flax leaf fills one port tensor, none is
left over or unfilled, and ``map_state_to_flax`` gives the tree back
exactly.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presight_tpu.configs.stage3_configs import map_configs as jax_map_configs
from presight_tpu.mapping.map_head import select_topk_for_propagation as jax_topk
from presight_tpu_torch import bridge
from presight_tpu_torch.configs.stage3_configs import map_configs
from presight_tpu_torch.mapping import StreamMapNet

T = torch.as_tensor
COMPARED = ("scores", "lines", "bev", "queries", "ref_pts")
PRIOR = dict(prior_pc_range=(-30.0, -15.0, -3.0, 30.0, 15.0, 5.0),
             prior_voxel_size=(1.0, 1.0, 1.0))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: six test workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rig(img_size, N=2):
    """N pinhole cameras round the ego car, looking outwards, 1.5 m up."""
    H, W = img_size
    intr = np.array([[0.6 * W, 0, W / 2 + 0.3], [0, 0.6 * W, H / 2 - 0.2], [0, 0, 1]])
    out = []
    for n in range(N):
        yaw = 2 * np.pi * n / N + 0.1
        c, s = np.cos(yaw), np.sin(yaw)
        cam2ego = np.eye(4)
        cam2ego[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ np.array(
            [[0, 0, 1], [-1, 0, 0], [0, -1, 0]])
        cam2ego[:3, 3] = [0.5 * c, 0.5 * s, 1.5]
        pad = np.eye(4)
        pad[:3, :3] = intr
        out.append(pad @ np.linalg.inv(cam2ego))
    return np.stack(out).astype(np.float32)


def random_variables(shapes, rng):
    """numpy leaves at ``shapes``: kernels N(0, 1 / fan_in), other leaves
    N(0, 0.1^2), BatchNorm variances in [0.5, 1.5), sampling-offset biases
    N(0, 1)."""
    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            shape = v.shape
            if k == "var":
                a = rng.rand(*shape) + 0.5
            elif len(shape) >= 2:
                a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
            elif k == "bias" and path[-1] == "sampling_offsets":
                a = rng.randn(*shape)
            else:
                a = rng.randn(*shape) * 0.1 + (1.0 if k == "scale" else 0.0)
            out[k] = a.astype(np.float32)
        return out
    return walk(shapes)


@pytest.fixture(scope="module")
def frames():
    jm = jax_map_configs["smn-toy"]().clone(**PRIOR)
    cfg = dataclasses.replace(map_configs["smn-toy"](), **PRIOR)
    D, (Hb, Wb), k = cfg.embed_dim, cfg.bev_hw, cfg.topk_propagate
    rng = np.random.RandomState(0)
    imgs = [rng.randn(2, 3, *cfg.img_size).astype(np.float32) for _ in range(2)]
    priors = []
    for _ in range(2):  # (z, y, x) < (8, 30, 60); the grid keeps x < 8 (the reference's indexing)
        cells = rng.permutation(8 * 30 * 12)[:300]
        priors.append(dict(prior_feats=rng.randn(300, 68).astype(np.float32),
                           prior_coords=np.stack([cells // 360, (cells // 12) % 30, cells % 12],
                                                 -1).astype(np.int32),
                           prior_valid=rng.rand(300) > 0.1))
    l2i = rig(cfg.img_size)
    a = 0.05
    p2c = np.array([[np.cos(a), -np.sin(a), 0.7], [np.sin(a), np.cos(a), -0.3], [0, 0, 1]],
                   np.float32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), imgs[0], l2i, prev_bev=jnp.zeros((D, Hb, Wb)),
        prev2curr=jnp.eye(3), prev_queries=jnp.zeros((k, D)),
        **{n: jnp.asarray(a) for n, a in priors[0].items()}))
    variables = random_variables(shapes, rng)

    apply = jax.jit(lambda v, *args, **kw: jm.apply(v, *args, mutable=["batch_stats"], **kw)[0])
    want = [apply(variables, imgs[0], l2i, **priors[0])]
    pq, pr = jax_topk(want[0], k)
    want.append(apply(variables, imgs[1], l2i, prev_bev=want[0]["bev"], prev2curr=p2c,
                      prev_queries=pq, prev_ref_pts=pr, **priors[1]))
    want[0]["prop_queries"], want[0]["prop_ref_pts"] = pq, pr

    model = StreamMapNet(cfg)
    bridge.map_state_from_flax(variables, model)
    model.eval()
    got = []
    tp = [{n: T(a) for n, a in p.items()} for p in priors]
    with torch.no_grad():
        got.append(model(T(imgs[0]), T(l2i), **tp[0]))
        got.append(model(T(imgs[1]), T(l2i), prev_bev=got[0]["bev"], prev2curr=T(p2c),
                         prev_queries=got[0]["prop_queries"],
                         prev_ref_pts=got[0]["prop_ref_pts"], **tp[1]))
    return variables, model, got, want


def gap(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(got.double().numpy() - want).max() / np.abs(want).max())


def test_two_streaming_frames_match_jax(frames):
    _, _, got, want = frames
    for g, w in zip(got, want):
        for key in COMPARED:
            assert gap(g[key], w[key]) < 1e-5, key
    for key in ("prop_queries", "prop_ref_pts"):
        assert gap(got[0][key], want[0][key]) < 1e-5, key


def test_bridge_fills_every_tensor_and_round_trips(frames):
    variables, model, _, _ = frames
    flat = dict(bridge._flatten(variables))
    assert len(flat) == len(model.state_dict())
    back = dict(bridge._flatten(bridge.map_state_to_flax(model)))
    assert set(back) == set(flat)
    for key, leaf in flat.items():
        assert back[key].shape == leaf.shape and np.array_equal(back[key], leaf), key


def test_bridge_refuses_a_tree_that_does_not_fit(frames):
    variables, model, _, _ = frames
    params = dict(variables["params"])
    params["head"] = {k: v for k, v in params["head"].items() if k != "query_update"}
    with pytest.raises(KeyError, match="unfilled"):
        bridge.map_state_from_flax({**variables, "params": params}, StreamMapNet(model.cfg))
