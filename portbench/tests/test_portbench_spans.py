"""harness.spans and the readers of the program's spans and counters, fed a
CPU profiler session of nested ranges with known sleeps. Launch calls are
ranges named as the CUDA runtime's launch call; the device's kernels are
laid onto the session's Trace by hand, each with its launch call's
correlation id, some before their launch (the lead the profiler shows on
the card). Each share must read within a tenth of the one the sleeps set;
a session without the cell's unit span reads None."""

from __future__ import annotations

import time
from types import SimpleNamespace

from torch.profiler import ProfilerActivity, profile, record_function

from tiny import HERE  # noqa: F401  (puts the benchmark on sys.path)

from harness import load, spans
from harness.trace import Trace

LAUNCH = "cudaLaunchKernel"
LEAD_US = -5000.0


def session(body) -> Trace:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        body()
        window = time.perf_counter() - t0
    return Trace(prof, window)


def launch(n: int = 1) -> None:
    for _ in range(n):
        with record_function(LAUNCH):
            pass


def with_kernels(trace: Trace, kernels) -> Trace:
    """Lay device events onto ``trace``: ``kernels(call)`` gives, for each
    launch call, its kernel's (start, end) in microseconds, or None."""
    events = []
    for e in trace.cpu_events:
        if e.name == LAUNCH:
            t = kernels(e)
            if t is not None:
                events.append(SimpleNamespace(id=e.id, name="kernel",
                                              time_range=SimpleNamespace(start=t[0], end=t[1])))
    trace.events = events
    trace.intervals = spans.union([(k.time_range.start, k.time_range.end) for k in events])
    trace.busy_s = spans.length(trace.intervals) / 1e6
    return trace


def near(got, want) -> bool:
    return got is not None and abs(got - want) <= 0.1 * want


def read(metric: str, trace, work=None):
    return load.metric(metric).read(trace, work or {})


def test_union_overlap_and_outermost_spans():
    assert spans.union([(3, 4), (0, 2), (1, 3), (6, 7)]) == [(0, 4), (6, 7)]
    assert spans.overlap([(0, 10), (20, 30)], [(5, 8), (9, 22), (29, 40)]) == 3 + 1 + 2 + 1

    def body():
        with record_function("s"):
            with record_function("s"):
                time.sleep(0.002)
        with record_function("s"):
            pass

    trace = session(body)
    assert len(spans.events(trace, "s")) == 2


def test_nerf_train_readers():
    steps, launches_a_step = 3, 7

    def body():
        launch(4)  # outside any step: not counted
        for _ in range(steps):
            with record_function("trainer.step"):
                with record_function("trainer.batch"):
                    time.sleep(0.02)
                launch(launches_a_step)
                time.sleep(0.08)

    trace = session(body)
    assert read("launches_per_step.nerf_train", trace) == launches_a_step
    assert near(read("data_wait.nerf_train", trace), 20.0)
    bare = session(lambda: (launch(3), time.sleep(0.01)))
    assert read("launches_per_step.nerf_train", bare) is None
    assert read("data_wait.nerf_train", bare) is None


def test_host_share_extract():
    def body():
        for _ in range(2):
            with record_function("extract.frame"):
                for _ in range(2):
                    with record_function("extract.render"):
                        time.sleep(0.03)
                    with record_function("extract.select"):
                        time.sleep(0.005)
                    with record_function("extract.query"):
                        time.sleep(0.01)
                    with record_function("extract.colors"):
                        time.sleep(0.005)
                    with record_function("extract.spill"):
                        time.sleep(0.005)
                with record_function("extract.fold"):
                    time.sleep(0.02)
                with record_function("extract.write"):
                    time.sleep(0.03)

    # per frame: 2 x (30 + 5 + 10 + 5 + 5) + 20 + 30 = 160 ms, 80 of it host
    assert near(read("host_share.extract", session(body)), 50.0)
    assert read("host_share.extract", session(lambda: time.sleep(0.01))) is None


def test_pad_share_extract_reads_the_program_counters(monkeypatch):
    from presight_tpu_torch.utils import profiler

    monkeypatch.setattr(profiler, "COUNTS", profiler.COUNTS.__class__())
    trace = session(lambda: None)
    assert read("pad_share.extract", trace) is None
    profiler.count("extract.rays", 57_600 * 6)
    profiler.count("extract.rays_padded", 65_536 * 6)
    profiler.count("extract.points", 30_000)
    profiler.count("extract.points_padded", 32_768)
    want = 100.0 * (1 - (57_600 * 6 + 30_000) / (65_536 * 6 + 32_768))
    assert abs(read("pad_share.extract", trace) - want) < 1e-9


def test_optimizer_share_occ_train():
    def body():
        for _ in range(2):
            with record_function("occ.train_step"):
                for _ in range(3):
                    launch(1)
                    time.sleep(0.005)
                with record_function("occ.optimizer"):
                    launch(1)
                    time.sleep(0.005)

    trace = session(body)
    in_opt = spans._within(spans.intervals(trace, "occ.optimizer"))
    # each launch's kernel runs 4 ms, 1 ms after its call; the optimizer's 2 ms
    with_kernels(trace, lambda e: (e.time_range.start + 1000, e.time_range.start + (
        3000 if in_opt(e.time_range.start) else 5000)))
    assert near(read("optimizer_share.occ_train", trace), 100.0 * (2 * 2) / (2 * 2 + 6 * 4))
    def no_step():
        with record_function("occ.optimizer"):
            launch(2)

    assert read("optimizer_share.occ_train", with_kernels(session(no_step),
                                                          lambda e: (0.0, 1.0))) is None


def test_model_idle_occ_serve_moves_the_device_by_the_lead():
    frame_us = 50_000.0

    def body():
        for _ in range(3):
            with record_function("occ.forward"):
                launch(1)
                time.sleep(frame_us / 1e6)
            time.sleep(0.01)

    trace = session(body)
    # each kernel busy for 0.6 of its frame from its launch, but shown 5 ms
    # early: read as it shows, the frame would be 0.5 idle
    with_kernels(trace, lambda e: (e.time_range.start + LEAD_US,
                                   e.time_range.start + LEAD_US + 0.6 * frame_us))
    assert spans.lead_us(trace) == LEAD_US
    forward = spans.length(spans.intervals(trace, "occ.forward"))
    want = 100.0 * (forward - 3 * 0.6 * frame_us) / forward
    assert near(read("model_idle.occ_serve", trace), want)
    assert not near(100.0 * (forward - spans.overlap(spans.intervals(trace, "occ.forward"),
                                                     trace.intervals)) / forward, want)
    assert read("model_idle.occ_serve", session(lambda: launch(1))) is None


def test_readers_match_their_benchmark_entries():
    import json

    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    names = {"launches_per_step.nerf_train": "nerf-c0-train",
             "data_wait.nerf_train": "nerf-c0-train", "host_share.extract": "nerf-c0-extract",
             "pad_share.extract": "nerf-c0-extract", "optimizer_share.occ_train": "occ-train-b4",
             "model_idle.occ_serve": "occ-serve-stream"}
    for m in bench["per_layer"]:
        if m["name"] in names:
            assert m["workloads"] == [names.pop(m["name"])]
    assert not names
