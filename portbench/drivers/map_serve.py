"""Driver of the online-mapping serving cell: ``StreamMapNet.forward`` of the
port over one camera rig's stream of frames, one frame at a time (a closed
loop of one client, as a car feeds it), with the city prior.

Each frame is timed from handing its host-side inputs over (the
host-to-device copy of its pinned images and priors included) to a
synchronise after its scores, lines and top-k hand-off. A frame takes the
previous frame's BEV (warped by the ego motion into the ConvGRU) and its
hand-off (queries and reference points); the stream cycles through
``distinct_frames`` frames made in set-up, with the rig's ego motion
between every two.

Set-up runs the stream's first frame (no history) and ``warmup_frames``
more, then one frame under the op counter, which also records the shapes
of every S3 call (kernel or plain version) for the rooflines. The check,
once the window has closed, runs ``reference.map`` on the first frame from
scratch, and on frames of the window drawn from the seed from the
program's own carried state (its BEV, hand-off queries and reference
points), and compares the scores, the lines, the BEV and the hand-off
queries. The reference follows the program's top-k choices (the queries
the decoder keeps, in order, and the hand-off): where two scores differ by
less than the rounding between the two, the choice is rounding's, and
either outcome is sound. ``order_gap`` holds each choice to the
reference's own scores (``reference.map.order_gap``).

Weights are flax's defaults (LeCun-normal kernels, zero biases, norms at
identity, embeddings N(0, 0.02^2)), but for the biases of every
sampling-offset projection and of DCNv2's offsets, drawn N(0, 1): the taps
land between pixel centres, one to two cells away, where a zero init would
put every DCN tap on a centre.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import random
import time
from typing import Dict, List

import torch

from counts import map as M
from counts.peaks import bound_s
from harness.opcount import count
from harness.trace import traced
from reference import map as ref
from traffic import map as traffic

COMPARED = ("scores", "lines", "bev", "prop_queries")
EMBEDDINGS = ("bev_queries", "pos_row", "pos_col", "bev_pos", "queries", "query_pos")
OFFSET_BIAS_STD = 1.0


def p95(values: List[float]) -> float:
    """The 95th percentile, by linear interpolation between order statistics."""
    s = sorted(values)
    pos = 0.95 * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def _fields(cls, model: Dict) -> Dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: (tuple(v) if isinstance(v, list) else v) for k, v in model.items() if k in names}


def port_config(config: Dict, adopt: bool = False):
    """The port's StreamMapNetConfig of the configuration, checked against
    the file field by field; ``adopt`` (CPU tests) takes the file's fields."""
    from presight_tpu_torch.configs.stage3_configs import map_configs
    from presight_tpu_torch.mapping import StreamMapNetConfig

    want = _fields(StreamMapNetConfig, config["model"])
    if adopt:
        return StreamMapNetConfig(**want)
    cfg = map_configs[config["name"]]()
    for f in dataclasses.fields(StreamMapNetConfig):
        got = getattr(cfg, f.name)
        got = tuple(got) if isinstance(got, (list, tuple)) else got
        if got != want.get(f.name):
            raise ValueError(f"the port's {config['name']} has {f.name} = {got!r}; the "
                             f"configuration's file says {want.get(f.name)!r}")
    return cfg


def ref_config(config: Dict):
    return ref.StreamMapNetConfig(**_fields(ref.StreamMapNetConfig, config["model"]))


def state_spec(config: Dict) -> Dict[str, tuple]:
    """Name -> shape of the reference model's state_dict, in order."""
    with torch.device("meta"):
        model = ref.StreamMapNet(ref_config(config), device="meta")
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def make_leaf(seed: int, index: int, name: str, shape: tuple, device) -> torch.Tensor:
    """Leaf ``index`` of the state_dict, from its own generator seeded by
    (seed, index)."""
    g = torch.Generator(device=device).manual_seed((seed * 1_000_003 + index) % (1 << 63))
    leaf = name.rsplit(".", 1)[-1]
    if leaf in EMBEDDINGS:
        return torch.randn(shape, generator=g, device=device) * 0.02
    if leaf == "kernel_w":  # DCNv2's (k*k*C, F) kernel: fan-in on the first axis
        return torch.randn(shape, generator=g, device=device) / shape[0] ** 0.5
    if len(shape) >= 2:
        return torch.randn(shape, generator=g, device=device) / math.prod(shape[1:]) ** 0.5
    out = torch.zeros(shape, device=device)
    if name.endswith("sampling_offsets.bias"):
        out = torch.randn(shape, generator=g, device=device) * OFFSET_BIAS_STD
    elif name.endswith("offset_mask.bias"):  # (dy, dx) of the k*k taps, then the mask logits
        taps = shape[0] // 3
        out[:2 * taps] = torch.randn((2 * taps,), generator=g, device=device) * OFFSET_BIAS_STD
    elif leaf in ("weight", "running_var"):  # a norm's scale or variance
        out.fill_(1.0)
    return out


def weights(seed: int, spec: Dict[str, tuple], device) -> Dict[str, torch.Tensor]:
    return {k: make_leaf(seed, i, k, s, device) for i, (k, s) in enumerate(spec.items())}


class _S3Recorder:
    """Records the shapes of every S3 call (kernel wrapper or plain version)
    while it is entered, as (bytes, FLOPs) by entry point."""

    NAMES = ("msda_fwd", "msda_plain", "deform_im2col_fwd", "deform_im2col_plain")

    def __init__(self):
        from presight_tpu_torch.mapping import deformable

        self.module = deformable
        self.calls: Dict[str, List] = {"msda": [], "dcn_im2col": []}

    def _msda(self, fn):
        def wrapped(value, levels, loc, attn, *args):
            B, Q, Hh, L, T = attn.shape
            self.calls["msda"].append(M.msda(B, Q, Hh, L, T, value.shape[1], value.shape[2]))
            return fn(value, levels, loc, attn, *args)
        return wrapped

    def _im2col(self, fn):
        def wrapped(x, offsets, mask, k, stride=1):
            B, H, W, C = x.shape
            self.calls["dcn_im2col"].append(
                M.dcn_im2col(B, H, W, C, offsets.shape[1], offsets.shape[2], k))
            return fn(x, offsets, mask, k, stride)
        return wrapped

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            setattr(self.module, n, self._msda(fn) if n.startswith("msda") else self._im2col(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)

    def work(self) -> Dict[str, float]:
        out = {}
        for kind, calls in self.calls.items():
            out[f"{kind}_bytes"] = sum(b for b, _ in calls)
            out[f"{kind}_flops"] = sum(f for _, f in calls)
            out[f"{kind}_bound_s"] = sum(bound_s(b, f) for b, f in calls)
            out[f"{kind}_calls"] = len(calls)
        return out


class Session:
    def __init__(self, cell: Dict, config: Dict, seed: int, device: str = "cuda",
                 adopt: bool = False):
        from presight_tpu_torch.mapping import StreamMapNet  # a program without it fails here

        self.cell, self.config, self.seed = cell, config, seed
        self.device = torch.device(device)
        self.spec = state_spec(config)
        self.model = StreamMapNet(port_config(config, adopt), device=self.device)
        self.model.load_state_dict(weights(seed, self.spec, self.device), strict=True)
        self.model.eval()
        self.geo = traffic.rig(config["model"], self.device)
        pin = self.device.type == "cuda"
        self.frames = [{k: (v.pin_memory() if pin else v) for k, v in f.items()}
                       for f in traffic.frames(seed, 0, cell["distinct_frames"], config["model"])]
        self.index = 0
        self.carried = None
        self.keep: List[int] = []
        self.kept: Dict[int, Dict[str, torch.Tensor]] = {}
        self.first = self._frame()
        for _ in range(cell["warmup_frames"] - 1):
            self._frame()
        with _S3Recorder() as s3:
            self.unit_work = count(self._frame)
        self.unit_work.update(s3.work())
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _frame(self) -> Dict[str, torch.Tensor]:
        """Serve the stream's next frame; returns its outputs and the state it
        was served from."""
        host = self.frames[self.index % len(self.frames)]
        inputs = {k: v.to(self.device, non_blocking=True) for k, v in host.items()}
        history = {} if self.carried is None else dict(
            prev_bev=self.carried["bev"], prev2curr=self.geo["prev2curr"],
            prev_queries=self.carried["prop_queries"], prev_ref_pts=self.carried["prop_ref_pts"])
        with torch.no_grad():
            out = self.model(inputs["imgs"], self.geo["lidar2img"],
                             prior_feats=inputs["prior_feats"],
                             prior_coords=inputs["prior_coords"],
                             prior_valid=inputs["prior_valid"], **history)
        record = {"index": self.index, "carried": self.carried, "keep": out.get("keep"),
                  **{k: out[k] for k in COMPARED + ("prop_ref_pts", "prop_index")}}
        self.carried = {k: out[k] for k in ("bev", "prop_queries", "prop_ref_pts")}
        self.index += 1
        return record

    def window(self, seconds: float):
        rng = random.Random(self.seed)
        start = self.index
        self.keep = [start + i for i in rng.sample(range(1, 64), self.cell["checked_frames"])]
        times: List[float] = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or not times:
            t = time.perf_counter()
            rec = self._frame()
            self._sync()
            times.append(time.perf_counter() - t)
            if rec["index"] in self.keep:
                self.kept[rec["index"]] = rec
        return {"occ_frame_ms_p95": 1e3 * p95(times)}, len(times), 0

    def trace(self):
        units = self.cell["trace_frames"]

        def run():
            for _ in range(units):
                self._frame()
                self._sync()

        trace = traced(run)
        work = {k: v * units for k, v in self.unit_work.items()}
        work["model_flops"] = (work["conv_fwd_flops"] + work["matmul_flops"]
                               + work["msda_flops"] + work["dcn_im2col_flops"])
        work["units"] = units
        return trace, work

    def _free(self) -> List[Dict]:
        """Free the program; returns the checked frames' records, the
        stream's first one first."""
        checked = [self.first] + [self.kept[i] for i in sorted(self.kept)]
        del self.model, self.first, self.kept, self.carried
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return checked

    def check(self):
        got = self._free()
        return compare(got, reference_frames(self, got, ieee=True), self.cell["limits"])

    def calibration(self) -> Dict[str, list]:
        """The control: the reference's convolutions and products in TF32,
        in the program's place."""
        got = self._free()
        control = reference_frames(self, [dict(f, keep=None, prop_index=None) for f in got],
                                   ieee=False)
        want = reference_frames(self, [dict(f, keep=c["keep"], prop_index=c["prop_index"])
                                       for f, c in zip(got, control)], ieee=True)
        return {"control": compare(control, want, self.cell["limits"])}


def compare(got: List[Dict], want: List[Dict], limits: Dict):
    """Each compared output's worst checked frame's gap over the reference's
    largest, and the worst of the program's top-k choices against the
    reference's scores."""
    out = [(f"{key}_rel_gap", max(rel_gap(g[key], w[key]) for g, w in zip(got, want)),
            limits[f"{key}_rel_gap"]) for key in COMPARED]
    return out + [("order_gap", max(max(w["order_gaps"]) for w in want), limits["order_gap"])]


def reference_frames(session: Session, frames: List[Dict], ieee: bool) -> List[Dict]:
    """The reference's outputs of each frame, from its stream index, the
    program's carried state (none for the first) and its top-k choices
    (``keep`` and ``prop_index``: None to choose them)."""
    dev = session.device
    model = ref.StreamMapNet(ref_config(session.config), device=dev)
    model.load_state_dict(weights(session.seed, session.spec, dev), strict=True)
    model.eval()
    geo = traffic.rig(session.config["model"], dev)
    out = []
    for f in frames:
        inputs = traffic.frames(session.seed, f["index"] % session.cell["distinct_frames"], 1,
                                session.config["model"], dev)[0]
        c = f["carried"]
        history = {} if c is None else dict(
            prev_bev=c["bev"], prev2curr=geo["prev2curr"], prev_queries=c["prop_queries"],
            prev_ref_pts=c["prop_ref_pts"])
        with torch.no_grad(), ref.ieee_convolutions(ieee):
            o = model(inputs["imgs"], geo["lidar2img"], prior_feats=inputs["prior_feats"],
                      prior_coords=inputs["prior_coords"], prior_valid=inputs["prior_valid"],
                      keep=f.get("keep"), prop_index=f.get("prop_index"), **history)
        out.append({k: o.get(k) for k in COMPARED + ("order_gaps", "keep", "prop_index")})
    return out


def setup(cell: Dict, config: Dict, seed: int) -> Session:
    return Session(cell, config, seed)


def window(session: Session, seconds: float):
    return session.window(seconds)


def trace(session: Session):
    return session.trace()
