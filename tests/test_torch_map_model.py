"""The online-mapping port (presight_tpu_torch.mapping) against the
benchmark's plain reference, portbench/reference/map.py, on the CPU: seeded
weights (the benchmark's own: offset biases drawn so the taps fall between
pixel centres), the benchmark's rig and frames, two streaming frames (the
second from the first's BEV and top-k hand-off, with the rig's ego motion)
with priors, for a preset at the published ratios (ResNet-50 with DCNv2, 3
FPN levels, 4 z anchors, 8 heads of 32, 8 SCA points, 20 points, prior
fusion; a small image, BEV and prior grid, 2 decoder layers) and smn-toy
(no priors: its configuration has no prior range).

Tolerance: every compared output within 2e-5 of its largest value. The
port sums in other orders than the reference: S3's plain version blends a
level's taps from one gather per corner over all heads, the reference per
head; the SCA sums the cameras' compacted slots, the reference every
camera over every query under masks; over the encoder, the ConvGRU, the
prior fusion and the decoder's layers the float32 roundings grow to ~1e-6
of an output's largest value.

A streamed forward, outside a profiler session, dispatches none of the
ATen ops that read from the card on the host (a tensor made from host data,
linalg's error check, nonzero, a scalar read, indexing by a boolean mask),
so on the card the host queues a whole frame without waiting for it
(tests/test_torch_cuda.py holds the card itself to it).

Also: the published configuration's widths and parameter count, and the
raster configuration refused.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

BENCH = Path(__file__).resolve().parent.parent / "portbench"
for p in (str(BENCH / "tests"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from drivers import map_serve as D  # noqa: E402
from harness import load  # noqa: E402
from reference import map as RM  # noqa: E402
from tiny import SEED  # noqa: E402
from tiny_map import smn  # noqa: E402
from traffic import map as TM  # noqa: E402

from presight_tpu_torch.configs.stage3_configs import map_configs  # noqa: E402
from presight_tpu_torch.mapping import StreamMapNet, StreamMapNetConfig  # noqa: E402
from presight_tpu_torch.utils.profiler import profiling  # noqa: E402

PUBLISHED = "smn_wcamprior_480_100x50_24e_randomdrop"
COMPARED = ("scores", "lines", "bev", "queries", "ref_pts", "prop_queries", "prop_ref_pts")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: six test workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def toy_config():
    """smn-toy as a benchmark configuration dict (no priors)."""
    model = {k: (list(v) if isinstance(v, tuple) else v)
             for k, v in dataclasses.asdict(map_configs["smn-toy"]()).items()}
    return {"name": "smn-toy", "model": model}


def toy_prior_config():
    """smn-toy with a prior range over its 60 x 30 m ROI: a 24 x 12 x 8 grid
    of 2.5 x 2.5 x 1 m voxels, 300 prior voxels a frame."""
    config = toy_config()
    config["model"].update(prior_pc_range=[-30.0, -15.0, -3.0, 30.0, 15.0, 5.0],
                           prior_voxel_size=[2.5, 2.5, 1.0], prior_max_voxels=300)
    return config


def preset(name: str):
    return {"published-ratios": lambda: smn()[1], "smn-toy": toy_config,
            "smn-toy-priors": toy_prior_config}[name]()


def build(config, seed=SEED):
    """(port model, reference model, rig), both models from one state_dict."""
    spec = D.state_spec(config)
    state = D.weights(seed, spec, "cpu")
    port = StreamMapNet(D.port_config(config, adopt=True))
    port.load_state_dict(state, strict=True)
    ref = RM.StreamMapNet(D.ref_config(config))
    ref.load_state_dict(state, strict=True)
    return port.eval(), ref.eval(), TM.rig(config["model"], "cpu")


def frame_inputs(config, index, seed=SEED):
    model = config["model"]
    if model.get("prior_pc_range") is None:
        g = torch.Generator().manual_seed(seed + index)
        H, W = model["img_size"]
        return {"imgs": torch.randn((6, 3, H, W), generator=g)}
    return TM.frames(seed, index, 1, model)[0]


def stream(model, config, rig, frames=2):
    """Serve ``frames`` frames in turn, each from the last one's BEV and
    hand-off; returns each frame's outputs."""
    outs, carried = [], {}
    for i in range(frames):
        inputs = frame_inputs(config, i)
        with torch.no_grad():
            out = model(inputs.pop("imgs"), rig["lidar2img"], **inputs, **carried)
        outs.append(out)
        carried = dict(prev_bev=out["bev"], prev2curr=rig["prev2curr"],
                       prev_queries=out["prop_queries"], prev_ref_pts=out["prop_ref_pts"])
    return outs


def rel_gap(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.fixture(scope="module", params=["published-ratios", "smn-toy"])
def served(request):
    torch.manual_seed(0)
    config = preset(request.param)
    port, ref, rig = build(config)
    return stream(port, config, rig), stream(ref, config, rig)


def test_port_matches_the_reference_over_two_streaming_frames(served):
    got, want = served
    for g, w in zip(got, want):
        # the same top-k choices: the queries the decoder keeps, in order, and the hand-off
        assert torch.equal(g["prop_index"], w["prop_index"])
        assert ("keep" in g) == ("keep" in w) and ("keep" not in g or torch.equal(g["keep"],
                                                                                   w["keep"]))
        for key in COMPARED:
            assert rel_gap(g[key], w[key]) < 2e-5, key
    assert "keep" in got[1] and "keep" not in got[0]


def test_published_config_builds_the_published_model():
    cfg = map_configs[PUBLISHED]()
    assert isinstance(cfg, StreamMapNetConfig)
    assert (cfg.img_size, cfg.bev_hw, cfg.embed_dim, cfg.num_heads) == ((480, 800), (50, 100),
                                                                        256, 8)
    assert (cfg.num_levels, cfg.num_z_anchors, cfg.enc_layers, cfg.dec_layers) == (3, 4, 1, 6)
    assert (cfg.num_queries, cfg.num_points, cfg.topk_propagate) == (100, 20, 33)
    assert (cfg.prior_voxel_channels, cfg.backbone, cfg.dcn, cfg.tsa_prev) == (
        68, "resnet", True, False)
    file = load.config(PUBLISHED)
    D.port_config(file)  # every field equal to the configuration file's
    model = StreamMapNet(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == file["parameters"]
    assert model.backbone.dcn_s4.kernel_w.shape == (9 * 2048, 2048)
    assert model.backbone.layer0.spatial_cross_attn.deformable_attention.capacity(5000) == 2500
    assert set(model.state_dict()) == set(D.state_spec(file))


def test_raster_config_is_refused():
    with pytest.raises(NotImplementedError, match=r"4\(d\)"):
        map_configs["nusc_raster_wcamprior_480_100x50_24e_randomdrop"]()


class HostReads(TorchDispatchMode):
    """Records each dispatched ATen op that, on tensors on the card, waits
    for the card: ``torch.tensor`` / ``as_tensor`` of host data
    (``lift_fresh``, then a copy from pageable memory), linalg's error check,
    ``nonzero``, a scalar read, and indexing by a boolean mask (a nonzero
    inside)."""

    OPS = ("aten.lift_fresh", "aten._linalg_check_errors", "aten.nonzero",
           "aten._local_scalar_dense")
    INDEXING = ("aten.index.Tensor", "aten.index_put_.default", "aten.index_put.default")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(self.OPS) or (name in self.INDEXING and any(
                i is not None and i.dtype == torch.bool for i in args[1])):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["smn-toy-priors", "published-ratios"])
def test_streamed_forward_reads_nothing_back_from_the_device(name):
    """Two frames, then a third with history (warp, ConvGRU, propagated
    queries) and priors under the op recorder: none of the ops that wait
    for the card is dispatched."""
    config = preset(name)
    port, _, rig = build(config)
    last = stream(port, config, rig)[-1]
    inputs = frame_inputs(config, 2)
    carried = dict(prev_bev=last["bev"], prev2curr=rig["prev2curr"],
                   prev_queries=last["prop_queries"], prev_ref_pts=last["prop_ref_pts"])
    assert not profiling()
    with torch.no_grad(), HostReads() as reads:
        out = port(inputs.pop("imgs"), rig["lidar2img"], **inputs, **carried)
    assert "keep" in out and port.cfg.prior_pc_range is not None
    assert reads.seen == []

