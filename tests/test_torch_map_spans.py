"""The online-mapping port's spans and counters (utils/profiler.py) in a
CPU torch.profiler session, on the benchmark's tiny configuration at the
published ratios (tests/test_torch_map_model.py's set-up): a streaming
frame holds each of ``map.forward``, ``map.image_encoder``,
``map.bev_encoder``, ``map.stream``, ``map.prior_fusion``, ``map.head`` and
``map.propagate`` once, nested as in the code, ``map.msda`` once for each
attention site (the temporal self-attention, the spatial
cross-attention, each decoder layer) and ``map.dcn_im2col`` once for each
DCNv2 layer; a stream's first frame has no ``map.stream``. Inside a
session the counters equal a hand count of the in-frustum (camera, query)
pairs from the reference's projection; outside one they count nothing
(their read would wait for the card); and the outputs are equal with the
profiler on and off."""

from __future__ import annotations

import math

import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_map_model import RM, build, frame_inputs, one_thread, preset  # noqa: F401

from presight_tpu_torch.utils import profiler

TREE = {"map.image_encoder": "map.forward", "map.bev_encoder": "map.forward",
        "map.stream": "map.forward", "map.prior_fusion": "map.forward",
        "map.head": "map.forward", "map.propagate": "map.forward"}
COUNTERS = ("map.sca_pairs", "map.sca_slots", "map.sca_overflow")


def _inside(child, parents) -> bool:
    return any(p.time_range.start <= child.time_range.start
               and child.time_range.end <= p.time_range.end for p in parents)


def test_spans_nest_once_a_frame_and_counters_count_by_hand():
    config = preset("published-ratios")
    port, _, rig = build(config)
    first = frame_inputs(config, 0)
    second = frame_inputs(config, 1)

    def serve(profiled: bool):
        before = {k: profiler.COUNTS[k] for k in COUNTERS}
        with torch.no_grad():
            out0 = port(first["imgs"], rig["lidar2img"],
                        **{k: v for k, v in first.items() if k != "imgs"})
            history = dict(prev_bev=out0["bev"], prev2curr=rig["prev2curr"],
                           prev_queries=out0["prop_queries"], prev_ref_pts=out0["prop_ref_pts"])
            if not profiled:
                out1 = port(second["imgs"], rig["lidar2img"], **history,
                            **{k: v for k, v in second.items() if k != "imgs"})
                return out1, None, before
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                out1 = port(second["imgs"], rig["lidar2img"], **history,
                            **{k: v for k, v in second.items() if k != "imgs"})
        return out1, [e for e in prof.events() if e.name.startswith("map.")], before

    off, _, before_off = serve(False)
    assert {k: profiler.COUNTS[k] for k in COUNTERS} == before_off
    on, events, before = serve(True)
    for key in ("scores", "lines", "bev", "prop_queries", "prop_ref_pts"):
        assert torch.equal(off[key], on[key]), key

    by = {}
    for e in events:
        by.setdefault(e.name, []).append(e)
    assert len(by["map.forward"]) == 1
    for name, parent in TREE.items():
        assert len(by[name]) == 1, name
        assert _inside(by[name][0], by[parent]), name
    model = config["model"]
    assert len(by["map.msda"]) == 2 * model["enc_layers"] + model["dec_layers"]
    assert len(by["map.dcn_im2col"]) == 2
    assert all(_inside(e, by["map.bev_encoder"] + by["map.head"]) for e in by["map.msda"])
    assert all(_inside(e, by["map.image_encoder"]) for e in by["map.dcn_im2col"])

    # the counters of the one frame served under the profiler, by hand
    H, W = model["bev_hw"]
    feat = (model["img_size"][0] // 8, model["img_size"][1] // 8)
    zs = tuple(torch.linspace(-3.0, 3.0, model["num_z_anchors"]).tolist())
    _, valid = RM.project_bev_to_cameras((H, W), model["roi_size"], rig["lidar2img"],
                                         model["img_size"], feat, zs)
    seen = valid.any(1).sum(1).tolist()
    K = math.ceil(H * W * model["sca_capacity_frac"])
    got = {k: profiler.COUNTS[k] - before[k] for k in COUNTERS}
    assert got == {"map.sca_pairs": sum(seen), "map.sca_slots": 6 * K,
                   "map.sca_overflow": sum(max(n - K, 0) for n in seen)}
    assert 0 < sum(seen) < 6 * H * W


def test_a_first_frame_has_no_stream_span():
    config = preset("smn-toy")
    port, _, rig = build(config)
    inputs = frame_inputs(config, 0)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        port(inputs["imgs"], rig["lidar2img"])
    names = [e.name for e in prof.events() if e.name.startswith("map.")]
    assert names.count("map.forward") == 1 and "map.stream" not in names
    assert "map.prior_fusion" not in names and names.count("map.propagate") == 1

