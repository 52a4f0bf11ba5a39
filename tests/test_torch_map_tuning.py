"""The mapping forward's convolutions under cuDNN's timing
(``utils.precision.tuned_convolutions``), on the CPU, for the benchmark's
tiny configuration at the published ratios and smn-toy
(tests/test_torch_map_model.py's set-up):

  * the process's ``cudnn.benchmark``, ``benchmark_limit`` and conv
    ``fp32_precision`` are what they were before a forward, and before a
    forward that raises inside the scope;
  * ``map.conv_tuned`` counts each distinct key of a ``F.conv2d`` call
    (input shape, weight shape, stride, padding, dtype), recorded by hand,
    once: a stream's first frame counts its keys, the second only the
    ConvGRU's new ones (none at the published ratios, whose ConvGRU shares
    its one key with PriorFusion2D's 1x1 fusion convolution; one in
    smn-toy, which has no prior fusion), a third 0; a second model of the
    same shapes counts 0; an occupancy forward (``BEVDetOcc``) counts 0
    and runs its convolutions outside cuDNN's timing;
  * the outputs equal those of the same frames with the scope off.
"""

from __future__ import annotations

import contextlib

import pytest
import torch
import torch.nn.functional as F

from test_torch_map_model import build, frame_inputs, one_thread, preset  # noqa: F401
from test_torch_occ_model import TOY, _inputs

from presight_tpu_torch.mapping import stream_mapnet
from presight_tpu_torch.models.layers import Conv, init_weights
from presight_tpu_torch.occupancy import BEVDetOcc, BEVDetOccConfig
from presight_tpu_torch.utils import profiler

OUTPUTS = ("scores", "lines", "bev", "queries", "ref_pts", "prop_queries", "prop_ref_pts",
           "prop_index")


@pytest.fixture
def fresh(monkeypatch):
    """A process that has met no mapping convolution and counted nothing."""
    monkeypatch.setattr(stream_mapnet, "_CONV_KEYS", set())
    monkeypatch.setattr(profiler, "COUNTS", profiler.COUNTS.__class__())
    return profiler.COUNTS


def flags():
    cudnn = torch.backends.cudnn
    return cudnn.benchmark, cudnn.benchmark_limit, cudnn.conv.fp32_precision


@contextlib.contextmanager
def process_flags(benchmark, limit, precision):
    """The process's cuDNN flags set for the test, its own restored after."""
    cudnn = torch.backends.cudnn
    before = flags()
    cudnn.benchmark, cudnn.benchmark_limit, cudnn.conv.fp32_precision = (
        benchmark, limit, precision)
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.benchmark_limit, cudnn.conv.fp32_precision = before


@contextlib.contextmanager
def recording_conv2d(monkeypatch):
    """Each ``F.conv2d`` call's key, in order, while active."""
    calls, real = [], F.conv2d

    def conv2d(x, w, bias=None, stride=1, padding=0, *args):
        pads = tuple(padding) if isinstance(padding, (list, tuple)) else (padding,) * 2
        calls.append((tuple(x.shape), tuple(w.shape), stride, pads, x.dtype))
        return real(x, w, bias, stride, padding, *args)

    with monkeypatch.context() as m:
        m.setattr(F, "conv2d", conv2d)
        yield calls


def serve(model, config, rig, frames):
    """Frames 0, 1, ... in turn, each from the last one's BEV and hand-off;
    yields each frame's outputs as it is served."""
    carried = {}
    for i in range(frames):
        inputs = frame_inputs(config, i)
        with torch.no_grad():
            out = model(inputs.pop("imgs"), rig["lidar2img"], **inputs, **carried)
        yield out
        carried = dict(prev_bev=out["bev"], prev2curr=rig["prev2curr"],
                       prev_queries=out["prop_queries"], prev_ref_pts=out["prop_ref_pts"])


@pytest.mark.parametrize("benchmark,limit,precision", [(False, 3, "tf32"), (True, 0, "ieee")])
def test_forward_restores_the_process_flags(fresh, benchmark, limit, precision):
    config = preset("smn-toy")
    port, _, rig = build(config)
    with process_flags(benchmark, limit, precision):
        list(serve(port, config, rig, 2))
        assert flags() == (benchmark, limit, precision)
        imgs = torch.zeros((6, 4, *config["model"]["img_size"]))  # 4 channels: a conv raises
        with pytest.raises(RuntimeError), torch.no_grad():
            port(imgs, rig["lidar2img"])
        assert flags() == (benchmark, limit, precision)


@pytest.mark.parametrize("name,gru_keys", [("published-ratios", 0), ("smn-toy", 1)])
def test_conv_tuned_counts_each_key_once(fresh, monkeypatch, name, gru_keys):
    config = preset(name)
    port, _, rig = build(config)
    met, new_keys, counted = set(), [], []
    with recording_conv2d(monkeypatch) as calls:
        for _ in serve(port, config, rig, 3):
            new_keys.append(len(set(calls) - met))
            met |= set(calls)
            calls.clear()
            counted.append(fresh["map.conv_tuned"] - sum(counted))
    assert counted == new_keys
    assert counted[0] > 0 and counted[1] == gru_keys and counted[2] == 0
    list(serve(build(config)[0], config, rig, 2))
    assert fresh["map.conv_tuned"] == sum(counted)


def test_occupancy_forward_counts_nothing(fresh):
    cfg = BEVDetOccConfig(**TOY)
    model = init_weights(BEVDetOcc(cfg, "cpu"), torch.Generator().manual_seed(3)).eval()
    imgs, geo, priors, prev = _inputs(TOY)
    timed = []
    for m in model.modules():
        if isinstance(m, Conv):
            m.register_forward_pre_hook(
                lambda m, args: timed.append(torch.backends.cudnn.benchmark))
    with torch.no_grad():
        model(torch.as_tensor(imgs[0]), *(torch.as_tensor(a) for a in geo),
              **{k: torch.as_tensor(v) for k, v in priors.items()},
              k2s_sensor=torch.as_tensor(prev["k2s_sensor"]))
    assert fresh["map.conv_tuned"] == 0
    assert timed and not any(timed)  # its convolutions keep cuDNN's heuristic


def test_outputs_equal_the_untuned_forward(fresh, monkeypatch):
    config = preset("published-ratios")
    port, _, rig = build(config)
    tuned = list(serve(port, config, rig, 2))
    monkeypatch.setattr(stream_mapnet, "tuned_convolutions", contextlib.nullcontext)
    heuristic = list(serve(port, config, rig, 2))
    for t, h in zip(tuned, heuristic):
        for key in OUTPUTS:
            assert torch.equal(t[key], h[key]), key
