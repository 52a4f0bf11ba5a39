"""Driver of the prior-extraction cells: the port's
``prior.extraction.extract_voxels`` over one six-camera frame at a time (a
closed loop), from a served tile NeRF.

Set-up: the port's ``NerfactoNuscMS`` built straight from the benchmark's
weights (made on the card from the seed; no training), the rig's frames
(``traffic.nerf``: the cameras moved by the ego motion between frames),
and a random DINO-to-RGB projection from the seed, as chip_smoke.py's
``extraction_inputs`` makes one. Each frame goes through
``extract_voxels`` as the extraction CLI calls it (its defaults:
``--downscale 5``, median depth, density threshold 1, voxels of 0.4 m,
the hit-quantile filter), without segmentation masks; its pickle and
preview go to a directory under TMPDIR, one file each, written anew every
frame. Set-up extracts the first frame, whose result the check keeps.

The check, once the window has closed, runs ``reference.extraction`` on
the first frame and on ``checked_frames`` frames of the window drawn from
the seed, and reads the voxels against it (``readings``); the cell's
limits name the readings it is held to (PERF.md gives why the others are
not).
"""

from __future__ import annotations

import contextlib
import gc
import io
import math
import random
import shutil
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from counts import nerf as counts
from drivers.nerf_train import port_config
from harness.trace import traced
from reference import extraction as ref_x
from reference import nerf as ref
from traffic import nerf as traffic


def dino_to_rgb(seed: int, dim: int) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed % (1 << 32))
    return {"reduction_matrix": rng.randn(dim, 3).astype(np.float32),
            "mean": np.full(dim, 0.5, np.float32), "rgb_min": np.full(3, -2.0, np.float32),
            "rgb_max": np.full(3, 2.0, np.float32)}


def frame_cameras(c2w: np.ndarray, frame: int, scale: float, device) -> Dict[str, torch.Tensor]:
    """Frame ``frame``'s six cameras, intrinsics scaled by ``scale``."""
    cams = traffic.cameras(c2w[6 * frame:6 * frame + 6], 900, 1600, device)
    for k in ("fx", "fy", "cx", "cy"):
        cams[k] = cams[k] * scale
    return cams


def voxel_index(points: np.ndarray, min_bound, voxel_size: float) -> np.ndarray:
    ijk = np.floor((points.astype(np.float64) - min_bound) / voxel_size).astype(np.int64)
    return (ijk[:, 0] << 42) | (ijk[:, 1] << 21) | ijk[:, 2]


def readings(got: List[Dict], want: List[Dict], voxel_size: float) -> Dict[str, float]:
    """Over the checked frames, the worst of: the voxel count's relative gap;
    the share of the reference's voxels the program lacks; on the voxels
    both hold with equal hits, the largest gap of the points (infinite where
    those are under half of the reference's voxels: the answer is missing)
    and of the colours, and the share of feature values that differ; and the
    origin's largest gap."""
    worst = dict.fromkeys(("voxel_count_rel_gap", "missing_voxel_share", "point_max_abs",
                           "color_max_abs", "feature_diff_share", "origin_max_abs"), 0.0)

    def keep(name, value):
        worst[name] = max(worst[name], value)

    for g, w in zip(got, want):
        n_w, n_g = len(w["hits"]), len(g["hits"])
        keep("voxel_count_rel_gap", abs(n_g - n_w) / max(n_w, 1))
        kg = voxel_index(g["points"], w["min_bound"], voxel_size)
        kw = voxel_index(w["points"], w["min_bound"], voxel_size)
        common, ig, iw = np.intersect1d(kg, kw, return_indices=True)
        if n_w:
            keep("missing_voxel_share", 1.0 - len(common) / n_w)
        same = g["hits"][ig] == w["hits"][iw]
        ig, iw = ig[same], iw[same]
        if 2 * len(ig) < n_w:
            keep("point_max_abs", math.inf)
        if len(ig):
            gap = lambda key: np.abs(g[key][ig].astype(np.float64)  # noqa: E731
                                     - w[key][iw].astype(np.float64))
            keep("point_max_abs", float(gap("points").max()))
            keep("color_max_abs", float(gap("colors").max()))
            keep("feature_diff_share", float((gap("features") > 0).mean()))
        keep("origin_max_abs", float(np.abs(g["origin"] - w["origin"]).max()))
    return worst


def compare(found: Dict[str, float], limits: Dict):
    """The readings the cell holds to a limit, each beside it."""
    return [(name, found[name], limits[name]) for name in limits]


class Session:
    def __init__(self, cell: Dict, config: Dict, seed: int, device: str = "cuda",
                 adopt: bool = False):
        from presight_tpu_torch.models.nerfacto_ms import NerfactoNuscMS

        self.cell, self.config, self.seed = cell, config, seed
        self.device = torch.device(device)
        self.model_cfg = config["model"]
        self.E = config["num_experts"]
        self.scale = 1.0 / cell["downscale"]
        self.H, self.W = int(900 * self.scale), int(1600 * self.scale)
        self.psf = self.model_cfg["pose_scale_factor"]
        mcfg = port_config(config, seed, adopt).pipeline.model
        self.aabbs, self.cent, self.c2w = traffic.scene(self.E, cell["distinct_frames"],
                                                        cell["ego_step"])
        self.shapes = ref.param_shapes(self.model_cfg, self.E, 6 * cell["distinct_frames"], 1)
        self.density_bias = self._density_bias()
        tree = self.weights(self.device)
        self.model = NerfactoNuscMS(mcfg, tree).to(self.device)
        del tree
        self.dino = dino_to_rgb(seed, self.model_cfg["semantic_dim"])
        self.items = [SimpleNamespace(H=900, W=1600, seg_path=None) for _ in range(6)]
        self.cams = [self._port_cameras(f) for f in range(cell["distinct_frames"])]
        self.out = tempfile.mkdtemp(prefix="portbench_extract_")
        self.index = 0
        self.kept: Dict[int, Dict] = {0: self._frame()}
        for _ in range(cell["warmup_frames"] - 1):
            self._frame()

    def weights(self, device, density_bias: float = None) -> Dict:
        """A served tile's field: the seed's weights with tables at the cell's
        scale and every density logit's bias at ``density_bias`` (the
        session's, by default)."""
        bias = self.density_bias if density_bias is None else density_bias
        return traffic.weights(self.seed, self.shapes, self.aabbs, self.cent, device,
                               table_scale=self.cell["table_scale"], density_bias=bias)

    def _density_bias(self) -> float:
        """The density biases that put the median of the mean density at the
        first frame's hits (a probe of every 16th pixel, by the reference) at
        the CLI's threshold 1: every seed's frames keep about half their
        hits. The hits move with the bias, so it is found in three rounds."""
        cams = frame_cameras(self.c2w, 0, self.scale, self.device)
        rows, cols = np.nonzero(np.ones((self.H, self.W), bool))
        index = np.concatenate([np.stack([np.full(len(rows), c, np.int32), rows, cols], -1)
                                for c in range(6)])[::16]
        bias = 0.0
        with torch.no_grad():
            o, d, _, _ = ref.generate_rays(cams, torch.from_numpy(index.astype(np.int32))
                                           .to(self.device))
            for _ in range(3):
                P = self.weights(self.device, bias)
                depth = ref_x.forward_depth(P, self.model_cfg, o, d)["depth"]
                world = o + d * depth[:, None]
                metres, z = depth / self.psf, world[:, 2] / self.psf
                hit = (metres > 0.5) & (metres < 50.0) & (z > -3.0) & (z < 6.0)
                density, _ = ref_x.point_queries(P, self.model_cfg, world[hit])
                bias -= float(torch.log(torch.median(density)))
        return bias

    def _port_cameras(self, frame: int):
        from presight_tpu_torch.data.cameras import CameraParams

        c = traffic.cameras(self.c2w[6 * frame:6 * frame + 6], 900, 1600, self.device)
        return CameraParams(c2w=c["c2w"], fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"],
                            video_ids=c["video_ids"])

    def _frame(self) -> Dict:
        """Extract the stream's next frame; returns its prior."""
        from presight_tpu_torch.prior.extraction import extract_voxels

        frame = self.index % len(self.cams)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):  # its per-frame counts
            result = extract_voxels(self.model, self.items, self.cams[frame], self.psf,
                                    np.zeros(3, np.float32), self.dino, self.out,
                                    camera_scaling_factor=self.scale)
        if self.index == 0:
            written = sum(p.stat().st_size for p in Path(self.out).iterdir())
            print(f"portbench: first frame: {' / '.join(log.getvalue().splitlines()[:3])}; "
                  f"{written} bytes written to {self.out}", file=sys.stderr)
        self.index += 1
        return dict(result, frame=frame)

    def window(self, seconds: float):
        rng = random.Random(self.seed)
        keep = {self.index + i for i in rng.sample(range(self.cell["sample_from"]),
                                                   self.cell["checked_frames"])}
        frames = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or frames == 0:
            i = self.index
            result = self._frame()
            frames += 1
            if i in keep:
                self.kept[i] = result
        elapsed = time.perf_counter() - t0
        return {"extract_frames_per_s": frames / elapsed}, frames, 0

    def trace(self):
        units = self.cell["trace_frames"]

        def run():
            for _ in range(units):
                self._frame()

        trace = traced(run)
        return trace, {"units": units, "model_flops": units * counts.depth_flops(
            self.model_cfg, 6 * self.H * self.W)}

    def _free(self) -> List[Dict]:
        kept = [self.kept[i] for i in sorted(self.kept)]
        del self.model, self.cams, self.kept
        shutil.rmtree(self.out, ignore_errors=True)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return kept

    def check(self):
        got = self._free()
        self.found = readings(got, reference_priors(self, got), self.cell["voxel_size"])
        return compare(self.found, self.cell["limits"])

    def calibration(self) -> Dict[str, list]:
        """The control (the reference's products in TF32, in the program's
        place): every reading, those without a limit too."""
        frames = self._free()
        want = reference_priors(self, frames)
        found = readings(reference_priors(self, frames, allow_tf32=True), want,
                         self.cell["voxel_size"])
        return {"control": [(n, v, self.cell["limits"].get(n)) for n, v in found.items()]}


def reference_priors(session: Session, frames: List[Dict], allow_tf32: bool = False):
    dev = session.device
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        P = session.weights(dev)
        return [ref_x.extract(P, session.model_cfg,
                              frame_cameras(session.c2w, f["frame"], session.scale, dev),
                              session.H, session.W, session.psf, np.zeros(3, np.float32),
                              session.dino, voxel_size=session.cell["voxel_size"])
                for f in frames]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def setup(cell: Dict, config: Dict, seed: int) -> Session:
    return Session(cell, config, seed)


def window(session: Session, seconds: float):
    return session.window(seconds)


def trace(session: Session):
    return session.trace()
