"""The occupancy port's model against the JAX package's BEVDetOcc, on the
CPU, through ``bridge.occ_state_from_flax`` (seeded numpy inputs; flax init
weights with BatchNorm statistics and affine parameters drawn at random):

  * two streaming frames with stereo, temporal align and voxel priors, for
    the toy topology ('simple' backbone and BEV encoder) and the reference
    topology at tiny widths (ResNet-50 at base width 8 + CustomFPN,
    CustomResNet3D + LSSFPN3D): occupancy logits at atol 1e-4 + rtol 1e-4,
    depth at atol 1e-5, the stereo features at atol 1e-5, and >= 0.999 of
    the voxels' argmax equal. Frame 2 takes frame 1's stereo features, a
    seeded previous BEV and an ego motion with rotation. The remaining
    gaps come from the geometry: get_lidar_coor and gen_stereo_grid run
    through jnp.linalg.inv / torch.linalg.inv and einsums ulps apart, so a
    frustum point within ~1e-6 m of a voxel face may change voxel (the test
    counts them) and a stereo sample within ulps of a pixel row may change
    the exact-zero bias mask;
  * the backbones and PriorFusion3DVoxel alone, on the streaming model's
    own variables, at atol 1e-4 + rtol 1e-4;
  * the bridge leaf for leaf: every flax leaf fills one port tensor, none
    left over or unfilled, and occ_state_to_flax gives the tree back
    exactly;
  * mapped_apply against the native batch (atol 1e-5), the named configs
    field for field, and prior_fusion='crossattn' refused.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from presight_tpu.configs.stage3_configs import occ_configs as jax_occ_configs
from presight_tpu.occupancy import BEVDetOcc as JaxBEVDetOcc
from presight_tpu.occupancy import backbones as JBB
from presight_tpu.occupancy import view_transformer as JV
from presight_tpu_torch import bridge
from presight_tpu_torch.configs.stage3_configs import occ_configs
from presight_tpu_torch.occupancy import BEVDetOcc, BEVDetOccConfig, mapped_apply
from presight_tpu_torch.occupancy import bev_pool as PB
from presight_tpu_torch.occupancy import view_transformer as PV

T = torch.as_tensor

TOY = dict(
    grid_config={"x": (-8.0, 8.0, 0.8), "y": (-8.0, 8.0, 0.8), "z": (-1.0, 3.0, 0.5),
                 "depth": (1.0, 9.0, 0.5)},
    input_size=(32, 64), downsample=16, view_out_channels=16, img_widths=(8, 16, 16, 32),
    neck_channels=32, bev_widths=(16, 32), bev_out_channels=16, occ_out_dim=16,
    num_classes=18, prior_pc_range=(-8.0, -8.0, -1.0, 8.0, 8.0, 3.0),
    prior_voxel_size=(0.8, 0.8, 0.5), temporal=True, stereo=True)
RESNET = dict(
    grid_config={"x": (-8.0, 8.0, 1.0), "y": (-8.0, 8.0, 1.0), "z": (-2.0, 2.0, 1.0),
                 "depth": (1.0, 9.0, 1.0)},
    input_size=(64, 96), downsample=16, view_out_channels=8, neck_channels=16,
    backbone="resnet", resnet_depth=50, resnet_base_width=8, bev_neck="lssfpn3d",
    occ_out_dim=8, num_classes=18, prior_pc_range=(-8.0, -8.0, -2.0, 8.0, 8.0, 2.0),
    prior_voxel_size=(1.0, 1.0, 1.0), temporal=True, stereo=True)


def _inputs(kw, B=1, N=2, seed=0):
    """Seeded cameras with general extrinsics looking outwards, priors, an
    ego motion with rotation and a previous BEV."""
    rng = np.random.RandomState(seed)
    H, W = kw["input_size"]
    s2e = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
    base = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float64)
    for b in range(B):
        for n in range(N):
            yaw = 2 * np.pi * n / N + rng.uniform(-0.2, 0.2)
            rz = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0],
                           [0, 0, 1]])
            s2e[b, n, :3, :3] = rz @ base
    s2e[..., :3, 3] = rng.randn(B, N, 3) * 0.3 + [0.0, 0.0, 0.5]
    intr = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    intr[..., 0, 0] = intr[..., 1, 1] = 0.6 * W
    intr[..., 0, 2], intr[..., 1, 2] = W / 2 + 0.3, H / 2 - 0.2
    post_rots = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    post_trans = np.zeros((B, N, 3), np.float32)
    bda = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    geo = (s2e, intr, post_rots, post_trans, bda)
    cfg = BEVDetOccConfig(**kw)
    gx, gy, gz = cfg.grid_size()
    pr, vs = np.asarray(kw["prior_pc_range"]), np.asarray(kw["prior_voxel_size"])
    res = np.round((pr[3:] - pr[:3]) / vs).astype(int)
    V = 48
    pf = rng.randn(B, V, 68).astype(np.float32)
    pc = np.stack([rng.randint(0, res[2], (B, V)), rng.randint(0, res[1], (B, V)),
                   rng.randint(0, res[0], (B, V))], -1).astype(np.int32)
    pv = rng.rand(B, V) > 0.2
    c, s = np.cos(0.03), np.sin(0.03)
    k2s = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
    k2s[..., 0, 0] = k2s[..., 2, 2] = c
    k2s[..., 0, 2], k2s[..., 2, 0] = s, -s
    k2s[..., :3, 3] = [0.31, -0.02, 0.27]
    a = 0.05
    p2c = np.tile(np.array([[np.cos(a), -np.sin(a), 0.7], [np.sin(a), np.cos(a), -0.3],
                            [0, 0, 1]], np.float32), (B, 1, 1))
    prev_bev = rng.randn(B, kw["view_out_channels"], gz, gy, gx).astype(np.float32)
    imgs = [rng.rand(B, N, 3, H, W).astype(np.float32) for _ in range(2)]
    priors = dict(prior_feats=pf, prior_coords=pc, prior_valid=pv)
    return imgs, geo, priors, dict(prev_bev=prev_bev, prev2curr=p2c, k2s_sensor=k2s)


def _randomise_norms(variables, rng):
    """BatchNorm statistics and affine parameters at random (flax inits them
    to the identity), so the bridge's mapping of each is tested."""
    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v)
            if k == "mean":
                v = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            elif k == "var":
                v = (rng.rand(*v.shape) + 0.5).astype(np.float32)
            elif k == "scale":
                v = (rng.rand(*v.shape) + 0.5).astype(np.float32)
            elif k == "bias" and any(p.startswith("BatchNorm") for p in path[-1:]):
                v = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            out[k] = v
        return out
    return {k: walk(v) for k, v in variables.items()}


@pytest.fixture(scope="module", params=["toy", "resnet"])
def streaming(request):
    kw = TOY if request.param == "toy" else RESNET
    imgs, geo, priors, prev = _inputs(kw)
    jm = JaxBEVDetOcc(**kw)
    variables = jm.init(jax.random.PRNGKey(0), imgs[0], *geo, **priors,
                        k2s_sensor=prev["k2s_sensor"])
    variables = _randomise_norms(jax.tree_util.tree_map(np.asarray, variables),
                                 np.random.RandomState(1))
    apply = jax.jit(lambda v, *a, **k: jm.apply(v, *a, **k))
    f1 = [np.asarray(o) for o in apply(variables, imgs[0], *geo, **priors,
                                       k2s_sensor=prev["k2s_sensor"])]
    f2 = [np.asarray(o) for o in apply(variables, imgs[1], *geo, **priors,
                                       prev_stereo_feat=f1[2], **prev)]
    model = BEVDetOcc(BEVDetOccConfig(**kw), device="cpu")
    bridge.occ_state_from_flax(variables, model)
    return dict(kw=kw, variables=variables, model=model, imgs=imgs, geo=geo, priors=priors,
                prev=prev, jax=(f1, f2), jm=jm)


def _port_frames(s):
    tens = lambda d: {k: T(v) for k, v in d.items()}  # noqa: E731
    geo = [T(a) for a in s["geo"]]
    with torch.no_grad():
        f1 = s["model"](T(s["imgs"][0]), *geo, **tens(s["priors"]),
                        k2s_sensor=T(s["prev"]["k2s_sensor"]))
        f2 = s["model"](T(s["imgs"][1]), *geo, **tens(s["priors"]), prev_stereo_feat=f1[2],
                        **tens(s["prev"]))
    return [o.numpy() for o in f1], [o.numpy() for o in f2]


def test_bevdet_occ_two_streaming_frames_match_jax(streaming):
    got = _port_frames(streaming)
    for frame, (g, w) in enumerate(zip(got, streaming["jax"]), start=1):
        occ, depth, stereo = g
        assert occ.shape == w[0].shape and depth.shape == w[1].shape and stereo.shape == w[2].shape
        np.testing.assert_allclose(stereo, w[2], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(depth, w[1], atol=1e-5)
        np.testing.assert_allclose(occ, w[0], atol=1e-4, rtol=1e-4)
        agree = float((occ.argmax(-1) == w[0].argmax(-1)).mean())
        print(f"frame {frame}: occ max abs err {np.abs(occ - w[0]).max():.3e}, argmax "
              f"agreement {agree:.6f}")
        assert agree >= 0.999
    # the frustum points whose voxel differs between the two geometries
    kw, geo = streaming["kw"], streaming["geo"]
    frustum = JV.create_frustum(kw["grid_config"]["depth"], kw["input_size"], kw["downsample"])
    cfg = BEVDetOccConfig(**kw)
    lb = [kw["grid_config"][k][0] for k in "xyz"]
    iv = [kw["grid_config"][k][2] for k in "xyz"]
    ranks_jax = PB.voxel_ranks(T(np.asarray(jax.jit(JV.get_lidar_coor)(frustum, *geo))), lb, iv,
                               cfg.grid_size())
    ranks = PB.voxel_ranks(PV.get_lidar_coor(T(frustum), *map(T, geo)), lb, iv, cfg.grid_size())
    moved = int((ranks != ranks_jax).sum())
    inside = int((ranks < ranks.max()).sum())
    print(f"frustum points: {ranks.numel()}, in the grid {inside}, voxel differs {moved}")
    assert inside > 0 and moved <= max(1, ranks.numel() // 1000)


def test_bridge_maps_every_leaf_both_ways(streaming):
    variables, model = streaming["variables"], streaming["model"]
    leaves = list(bridge._flatten(variables))
    assert len(leaves) == len(model.state_dict())
    back = dict(bridge._flatten(bridge.occ_state_to_flax(model)))
    want = dict(bridge._flatten(variables))
    assert back.keys() == want.keys()
    for path, a in want.items():
        np.testing.assert_array_equal(back[path], a)
    extra = {"params": {**variables["params"], "Stray_0": {"kernel": np.zeros((1, 1))}},
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="no port tensor"):
        bridge.occ_state_from_flax(extra, BEVDetOcc(BEVDetOccConfig(**streaming["kw"]), "cpu"))
    short = {"params": variables["params"],
             "batch_stats": {k: v for k, v in variables["batch_stats"].items()
                             if k != next(iter(variables["batch_stats"]))}}
    with pytest.raises(KeyError, match="unfilled"):
        bridge.occ_state_from_flax(short, BEVDetOcc(BEVDetOccConfig(**streaming["kw"]), "cpu"))


def _sub(variables, name):
    return {c: variables[c][name] for c in ("params", "batch_stats") if name in variables[c]}


@pytest.mark.parametrize("streaming", ["resnet"], indirect=True)
def test_backbones_and_prior_fusion_match_jax(streaming):
    """The reference-topology parts alone, on the streaming model's weights."""
    kw, v, model = streaming["kw"], streaming["variables"], streaming["model"]
    rng = np.random.RandomState(11)
    x = rng.rand(2, *kw["input_size"], 3).astype(np.float32)
    trunk = JBB.ResNet(50, (0, 2, 3), kw["resnet_base_width"])
    want = jax.jit(trunk.apply)(_sub(v, "ResNet_0"), x)
    fpn_want = JBB.CustomFPN(kw["neck_channels"], (0,)).apply(_sub(v, "CustomFPN_0"),
                                                               list(want[1:]))
    with torch.no_grad():
        got = model.ResNet_0(T(np.moveaxis(x, -1, 1).copy()))
        fpn_got = model.CustomFPN_0(got[1:])
    for g, w in zip(got + [fpn_got], list(want) + [fpn_want]):
        np.testing.assert_allclose(np.moveaxis(g.numpy(), 1, -1), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)
    C = kw["view_out_channels"]
    vol = rng.randn(1, 4, 16, 16, C).astype(np.float32)  # NDHWC, D = Z
    feats = JBB.CustomResNet3D((1, 2, 4), (C, 2 * C, 4 * C), (1, 2, 2)).apply(
        _sub(v, "CustomResNet3D_0"), vol)
    fpn3 = JBB.LSSFPN3D(C).apply(_sub(v, "LSSFPN3D_0"), feats)
    with torch.no_grad():
        pfeats = model.CustomResNet3D_0(T(np.moveaxis(vol, -1, 1).copy()))
        pfpn3 = model.LSSFPN3D_0(pfeats)
    for g, w in zip(pfeats + [pfpn3], list(feats) + [fpn3]):
        np.testing.assert_allclose(np.moveaxis(g.numpy(), 1, -1), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)
    from presight_tpu.models.prior_fusion import PriorFusion3DVoxel as JaxFusion

    bev = rng.randn(1, C, 16, 16, 4).astype(np.float32)
    fusion = JaxFusion(prior_pc_range=kw["prior_pc_range"],
                       prior_voxel_size=kw["prior_voxel_size"],
                       bev_hidden_channels=kw["neck_channels"], out_num_z=4, out_channels=C)
    p = streaming["priors"]
    want = fusion.apply(_sub(v, "PriorFusion3DVoxel_0"), bev, p["prior_feats"],
                        p["prior_coords"], p["prior_valid"])
    with torch.no_grad():
        got = model.PriorFusion3DVoxel_0(T(bev), T(p["prior_feats"]), T(p["prior_coords"]),
                                         T(p["prior_valid"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_mapped_apply_matches_native_batch():
    from presight_tpu_torch.models.layers import init_weights

    cfg = BEVDetOccConfig(**TOY)
    model = init_weights(BEVDetOcc(cfg, "cpu"), torch.Generator().manual_seed(3))
    imgs, geo, priors, prev = _inputs(TOY, B=4, seed=5)
    args = [T(imgs[0])] + [T(a) for a in geo]
    kwargs = {**{k: T(v) for k, v in priors.items()}, "k2s_sensor": T(prev["k2s_sensor"]),
              "prev_bev": T(prev["prev_bev"]), "prev2curr": T(prev["prev2curr"])}
    with torch.no_grad():
        native = model(*args, **kwargs)
        for chunk in (1, 2):
            out = mapped_apply(model, args, kwargs, chunk_size=chunk)
            assert len(out) == len(native)
            for o, n in zip(out, native):
                assert o.shape == n.shape
                np.testing.assert_allclose(o.numpy(), n.numpy(), atol=1e-5, rtol=1e-5)
        with pytest.raises(ValueError):
            mapped_apply(model, args, kwargs, chunk_size=3)


@pytest.mark.parametrize("name", sorted(occ_configs))
def test_occ_configs_match_jax(name):
    port, ref = occ_configs[name](), jax_occ_configs[name]()
    for field in dataclasses.fields(BEVDetOccConfig):
        want = getattr(ref, field.name)
        got = getattr(port, field.name)
        if isinstance(want, (list, tuple)):
            want, got = tuple(want), tuple(got)
        assert got == want, field.name


def test_crossattn_fusion_is_refused():
    cfg = BEVDetOccConfig(**{**TOY, "prior_fusion": "crossattn"})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BEVDetOcc(cfg, "cpu")
