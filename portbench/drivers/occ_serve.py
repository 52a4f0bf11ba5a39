"""Driver of the occupancy serving cells: ``BEVDetOcc.forward`` of the port
in eval mode over one camera rig's stream of frames, one frame at a time
(a closed loop of one client, as a car feeds it).

Each frame is timed from handing its host-side inputs over (the
host-to-device copy of its images and priors included) to a synchronise
after its logits. A frame's ``prev_stereo_feat`` is the previous frame's
stereo output and its ``prev_bev`` the previous frame's BEV volume from the
view transformer (read by a forward hook on ``LSSViewTransformer_0``, the
volume the temporal fusion concatenates): the model returns no BEV. The
stream cycles through ``distinct_frames`` frames made in set-up, with the
rig's ego motion between every two.

Set-up runs the stream's first frame (no history) and ``warmup_frames``
more. The check, once the window has closed, runs ``reference.occ`` on
the first frame from scratch, and on ``checked_frames`` frames of the
window drawn from the seed from the program's own carried state (their
``prev_bev`` and ``prev_stereo_feat``), and compares the logits and both
carried outputs.
"""

from __future__ import annotations

import gc
import random
import time
from typing import Dict, List

import torch

from drivers.occ_train import port_config, ref_config, state_spec, weights
from harness.opcount import count
from harness.trace import traced
from reference import occ as ref
from traffic import occ as traffic

PRIOR_KEYS = ("prior_feats", "prior_coords", "prior_valid")


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


class Session:
    def __init__(self, cell: Dict, config: Dict, seed: int, device: str = "cuda",
                 adopt: bool = False):
        from presight_tpu_torch.occupancy import BEVDetOcc

        self.cell, self.config, self.seed = cell, config, seed
        self.device = torch.device(device)
        self.spec = state_spec(config)
        self.model = BEVDetOcc(port_config(config, adopt), device=self.device,
                               with_prior_fusion=True)
        self.model.load_state_dict(weights(seed, self.spec, self.device), strict=True)
        self.model.eval()
        self.geo = traffic.rig(1, self.device)
        pin = self.device.type == "cuda"
        self.frames = [{k: (v.pin_memory() if pin else v) for k, v in f.items()}
                       for f in traffic.frames(seed, 0, cell["distinct_frames"], config["model"],
                                               False)]
        self._bev = None
        self.model.LSSViewTransformer_0.register_forward_hook(self._keep_bev)
        self.index = 0
        self.prev_bev = self.prev_stereo = None
        self.keep = set()
        self.kept: Dict[int, Dict[str, torch.Tensor]] = {}
        self.first = self._frame()
        for _ in range(cell["warmup_frames"] - 1):
            self._frame()
        self.unit_work = count(self._frame)
        self._sync()

    def _keep_bev(self, module, args, out):
        self._bev = out[0]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _frame(self) -> Dict[str, torch.Tensor]:
        """Serve the stream's next frame; returns its inputs and outputs."""
        host = self.frames[self.index % len(self.frames)]
        inputs = {k: v.to(self.device, non_blocking=True) for k, v in host.items()}
        history = {} if self.prev_stereo is None else dict(
            prev_bev=self.prev_bev, prev2curr=self.geo["prev2curr"],
            prev_stereo_feat=self.prev_stereo)
        with torch.no_grad():
            occ, _, stereo = self.model(inputs["imgs"], *[self.geo[k] for k in ref.MODEL_INPUTS
                                                          if k != "imgs"],
                                        **{k: inputs[k] for k in PRIOR_KEYS}, **history,
                                        k2s_sensor=self.geo["k2s_sensor"])
        record = {"index": self.index, "occ": occ, "stereo": stereo, "bev": self._bev,
                  "prev_bev": self.prev_bev, "prev_stereo": self.prev_stereo}
        self.prev_bev, self.prev_stereo = self._bev, stereo
        self.index += 1
        return record

    def window(self, seconds: float):
        rng = random.Random(self.seed)
        start = self.index
        self.keep = {start + i for i in rng.sample(range(1, 64), self.cell["checked_frames"])}
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
        work["model_flops"] = work["conv_fwd_flops"] + work["matmul_flops"]
        work["units"] = units
        return trace, work

    def _free(self):
        """Free the program; returns the checked frames' records."""
        checked = [{k: self.first[k] for k in ("occ", "stereo", "bev")}]
        checked += list(self.kept.values())
        del self.model, self._bev, self.prev_bev, self.prev_stereo, self.first, self.kept
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return checked

    def _inputs(self, checked):
        """Each checked frame's stream index and carried state (none for the
        stream's first frame)."""
        return [dict(index=0, prev_bev=None, prev_stereo=None)] + checked[1:]

    def check(self):
        got = self._free()
        return compare(got, reference_frames(self, self._inputs(got), ieee=True),
                       self.cell["limits"])

    def calibration(self) -> Dict[str, list]:
        """The control: the reference's convolutions and products in TF32,
        in the program's place."""
        frames = self._inputs(self._free())
        want = reference_frames(self, frames, ieee=True)
        return {"control": compare(reference_frames(self, frames, ieee=False), want,
                                   self.cell["limits"])}


def compare(got: List[Dict], want: List[Dict], limits: Dict):
    """The worst checked frame's gap of the logits, the carried BEV volume
    and the carried stereo features, each over the reference's largest."""
    return [(f"{key}_rel_gap", max(rel_gap(g[key], w[key]) for g, w in zip(got, want)),
             limits[f"{key}_rel_gap"]) for key in ("occ", "bev", "stereo")]


def reference_frames(session: Session, frames: List[Dict], ieee: bool) -> List[Dict]:
    """The reference's outputs of each frame (its stream index and carried
    prev_bev / prev_stereo, None for the first)."""
    dev = session.device
    model = ref.BEVDetOcc(ref_config(session.config), device=dev, with_prior_fusion=True)
    model.load_state_dict(weights(session.seed, session.spec, dev), strict=True)
    model.eval()
    kept = {}
    model.LSSViewTransformer_0.register_forward_hook(
        lambda m, a, out: kept.__setitem__("bev", out[0]))
    geo = traffic.rig(1, dev)
    out = []
    for f in frames:
        inputs = traffic.frames(session.seed, f["index"] % session.cell["distinct_frames"], 1,
                                session.config["model"], False, dev)[0]
        history = (dict(prev_bev=None, prev2curr=None, prev_stereo=None)
                   if f["prev_stereo"] is None else
                   dict(prev_bev=f["prev_bev"], prev2curr=geo["prev2curr"],
                        prev_stereo=f["prev_stereo"]))
        with torch.no_grad(), ref.ieee_convolutions(ieee):
            occ, _, stereo = model._forward(
                inputs["imgs"], *[geo[k] for k in ref.MODEL_INPUTS if k != "imgs"],
                *[inputs[k] for k in PRIOR_KEYS], history["prev_bev"], history["prev2curr"],
                history["prev_stereo"], geo["k2s_sensor"])
        out.append({"occ": occ, "stereo": stereo, "bev": kept["bev"]})
    return out


def setup(cell: Dict, config: Dict, seed: int) -> Session:
    return Session(cell, config, seed)


def window(session: Session, seconds: float):
    return session.window(seconds)


def trace(session: Session):
    return session.trace()
