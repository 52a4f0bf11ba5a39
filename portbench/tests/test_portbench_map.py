"""The online-mapping cell's parts on the CPU: S3's counts pinned to a hand
count; its six readers on a hand-laid trace (as test_portbench_spans.py
lays them); and a tiny run of the map_serve driver against
``reference.map``, with ``correct`` false under each fault the cell can
have: a deformable tap that misses the map it samples, and a top-k choice
that keeps the wrong queries."""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from test_portbench_spans import launch, near, read, session, with_kernels
from tiny import SEED
from tiny_map import smn

from counts import map as M
from counts.peaks import F32_FLOPS_PER_S, bound_s
from harness import load, spans


def test_s3_counts_by_hand():
    # msda: 1 map of 10 rows x 8 channels, 2 queries x 2 heads x 1 level x 3 taps
    b, f = M.msda(1, 2, 2, 1, 3, 10, 8)
    assert b == 4 * (10 * 8 + 3 * 12 + 2 * 8) and f == 8 * 2 * 8 * 3
    # im2col: 1 image 4 x 5 x 6, 4 x 5 outputs x 9 taps
    b, f = M.dcn_im2col(1, 4, 5, 6, 4, 5, 3)
    assert b == 4 * (4 * 5 * 6 + 3 * 180 + 180 * 6) and f == 9 * 180 * 6


def test_map_serve_readers():
    frame_us = 40_000.0

    def body():  # each kernel ends before the next launch (4 ms apart)
        for _ in range(3):
            with record_function("map.forward"):
                with record_function("map.dcn_im2col"):
                    launch(1)
                time.sleep(0.004)
                for _ in range(2):
                    with record_function("map.msda"):
                        launch(1)
                    time.sleep(0.004)
                for _ in range(2):
                    launch(1)
                    time.sleep(0.004)
                time.sleep(frame_us / 1e6)

    trace = session(body)
    inside = {n: spans._within(spans.intervals(trace, n)) for n in ("map.msda", "map.dcn_im2col")}

    def kernels(e):  # 2 ms a msda launch, 3 ms an im2col one, 1 ms the rest
        t = e.time_range.start
        length = 2000 if inside["map.msda"](t) else 3000 if inside["map.dcn_im2col"](t) else 1000
        return t, t + length

    with_kernels(trace, kernels)
    work = {"msda_bound_s": 3 * 2 * 0.001, "dcn_im2col_bound_s": 3 * 0.0015,
            "model_flops": 1e12}
    assert near(read("msda_roofline", trace, work), 50.0)
    assert near(read("dcn_im2col_roofline", trace, work), 50.0)
    assert near(read("mfu.map_serve", trace, work), 100.0 * 1e12 / (trace.window_s
                                                                      * F32_FLOPS_PER_S))
    busy = 3 * (2 * 2 + 3 + 2 * 1) * 1000.0
    assert near(read("device_idle.map_serve", trace, work), 100.0 * (1 - busy / 1e6
                                                                     / trace.window_s))
    forward = spans.length(spans.intervals(trace, "map.forward"))
    assert near(read("model_idle.map_serve", trace, work), 100.0 * (forward - busy) / forward)
    bare = session(lambda: launch(1))
    for name in ("msda_roofline", "dcn_im2col_roofline", "model_idle.map_serve"):
        assert read(name, bare, work) is None


def test_sca_fill_reads_the_program_counters(monkeypatch):
    from presight_tpu_torch.utils import profiler

    monkeypatch.setattr(profiler, "COUNTS", profiler.COUNTS.__class__())
    trace = session(lambda: None)
    assert read("sca_fill.map_serve", trace) is None
    profiler.count("map.sca_pairs", 4_000)
    profiler.count("map.sca_slots", 15_000)
    assert abs(read("sca_fill.map_serve", trace) - 100.0 * 4_000 / 15_000) < 1e-12


def correct(checks) -> bool:
    return all(value <= limit for _, value, limit in checks)


def session_():
    cell, cfg = smn()
    return load.driver("map_serve").Session(cell, cfg, SEED, device="cpu", adopt=True)


def test_map_serve_matches_its_reference():
    s = session_()
    values, attempted, failed = s.window(0.3)
    assert attempted >= 1 and failed == 0 and values["occ_frame_ms_p95"] > 0
    work = s.unit_work
    assert work["conv_fwd_flops"] > 0 and work["conv_bwd_flops"] == 0
    assert work["msda_calls"] == 2 + 2 and work["dcn_im2col_calls"] == 2
    assert work["msda_bound_s"] == sum(bound_s(*M.msda(*c)) for c in s_calls(s))
    checks = s.check()
    assert [c[0] for c in checks] == ["scores_rel_gap", "lines_rel_gap", "bev_rel_gap",
                                      "prop_queries_rel_gap", "order_gap"]
    assert correct(checks), checks


def s_calls(s):
    """The msda calls a frame of the tiny cell makes: (B, Q, heads, L, T, R,
    D) of the temporal self-attention, the spatial cross-attention and the
    two decoder layers."""
    m = s.config["model"]
    H, W = m["bev_hw"]
    Q, D, Hh = H * W, m["embed_dim"], m["num_heads"]
    h, w = m["img_size"][0] // 8, m["img_size"][1] // 8
    R = h * w + (h // 2) * (w // 2) + (h // 4) * (w // 4)
    K = -(-Q * 1 // 2)
    dec = (1, m["num_queries"], Hh, 1, m["num_points"], Q, D)
    return [(1, Q, Hh, 2, 4, Q, D), (6, K, Hh, 3, 8, R, D), dec, dec]


def test_map_serve_fails_a_tap_off_its_map(monkeypatch):
    from presight_tpu_torch.mapping import deformable

    plain = deformable.msda_plain
    monkeypatch.setattr(deformable, "msda_plain", lambda value, levels, loc, attn: plain(
        value, levels, loc + 0.5, attn))
    s = session_()
    s.window(0.01)
    assert not correct(s.check())


def test_map_serve_fails_a_hand_off_of_the_wrong_queries(monkeypatch):
    from presight_tpu_torch.mapping import stream_mapnet

    def lowest(out, k):
        idx = torch.topk(-out["scores"].max(-1).values, k).indices
        return idx, out["queries"][idx], out["ref_pts"][idx]

    monkeypatch.setattr(stream_mapnet, "select_topk_for_propagation", lowest)
    s = session_()
    s.window(0.01)
    checks = dict((n, (v, lim)) for n, v, lim in s.check())
    assert checks["order_gap"][0] > checks["order_gap"][1]
