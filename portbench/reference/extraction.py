"""Plain reference of prior extraction over one frame of six cameras.

A frozen plain copy of ``presight_tpu_torch`` at commit db696f7:
prior/extraction.py (``extract_frame_points``, ``extract_voxels`` without
segmentation masks), models/nerfacto_ms.py (``forward_depth``,
``point_queries``), ops/renderers.py (the median and expected depth),
prior/voxelize.py (``voxel_keys``, the per-voxel means accumulated point
by point in arrival order, ``hit_quantile_filter``) and
utils/colormaps.py (``apply_feature_colormap``). The model is
``reference.nerf``'s, in eval mode (deterministic samples, no anneal).
Imports nothing of the port.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from reference import nerf as N


def _field(P: Dict, model: Dict, flat: torch.Tensor):
    """Main-field density and semantic embedding at world positions (n, 3)."""
    f = P["field"]
    E = f["centroids"].shape[0]
    e = N.assign_experts(flat, f["centroids"])
    unit, sel = N.contract_positions(flat, f["aabbs"][e])
    h = N.grouped_mlp(f["base_mlp"], N.hash_encode(f["hash_table"], unit, N.hash_spec(model), e),
                      e, E)
    return N.trunc_exp(h[:, 0]) * sel, h[:, 16:], e


def forward_depth(P: Dict, model: Dict, origins, directions, threshold: float = 0.5):
    """Median and expected depth of rays (no jitter, anneal 1)."""
    E = P["field"]["centroids"].shape[0]
    R = origins.shape[0]
    thr = model["piecewise_sampler_threshold"]
    nears = torch.full((R,), model["near_plane"], device=origins.device)
    fars = torch.full((R,), model["far_plane"], device=origins.device)
    eps = float(torch.finfo(torch.float32).eps)
    n_prop = len(model["num_proposal_samples_per_ray"])
    s = w = None
    for lvl in range(n_prop + 1):
        num = (model["num_proposal_samples_per_ray"][lvl] if lvl < n_prop
               else model["num_nerf_samples_per_ray"])
        s = (N.spaced_sample(nears, fars, num, thr) if lvl == 0
             else N.pdf_sample(nears, fars, s, w, num, thr, None, eps))
        if lvl < n_prop:
            dens = N.prop_density(P["props"][lvl], N.hash_spec(model, lvl),
                                  N.positions(origins, directions, s), E)
            w = N.get_weights(s["ends"] - s["starts"], dens)
    S = s["starts"].shape[1]
    density = _field(P, model, N.positions(origins, directions, s).reshape(-1, 3))[0]
    weights = N.get_weights(s["ends"] - s["starts"], density.reshape(R, S))
    steps = (s["starts"] + s["ends"]) / 2.0
    cum = torch.cumsum(weights, dim=-1)
    idx = torch.searchsorted(cum.contiguous(), torch.full((R, 1), threshold, device=cum.device),
                             right=False)
    median = torch.gather(steps, -1, torch.clamp(idx, 0, S - 1))[..., 0]
    expected = torch.sum(weights * steps, -1) / (torch.sum(weights, -1) + 1e-10)
    lo, hi = torch.aminmax(steps)
    return {"depth": median, "expected_depth": N.clip(expected, lo, hi)}


def point_queries(P: Dict, model: Dict, positions: torch.Tensor):
    """Mean density over the main field and every proposal round, and the
    [0, 1]-clipped semantic features, at world positions (n, 3)."""
    E = P["field"]["centroids"].shape[0]
    density, sem_emb, e = _field(P, model, positions)
    feats = N.grouped_mlp(P["field"]["semantic_head"], sem_emb, e, E)
    densities = [density] + [N.prop_density(P["props"][i], N.hash_spec(model, i), positions, E)
                             for i in range(len(model["num_proposal_samples_per_ray"]))]
    return sum(densities) / len(densities), torch.clamp(feats, 0.0, 1.0)


def colormap(features: np.ndarray, dino_to_rgb: Dict) -> np.ndarray:
    red = np.asarray(dino_to_rgb["reduction_matrix"], np.float32)
    lo = np.asarray(dino_to_rgb["rgb_min"], np.float32)
    hi = np.asarray(dino_to_rgb["rgb_max"], np.float32)
    img = (features.astype(np.float32) - np.asarray(dino_to_rgb["mean"], np.float32)) @ red
    return np.clip((img - lo) / (hi - lo), 0.0, 1.0)


def camera_points(P: Dict, model: Dict, cameras: Dict, cam: int, H: int, W: int,
                  psf: float, max_depth: float, min_depth: float, depth_type: str,
                  z_bounds=(-3.0, 6.0), chunk: int = 1 << 17):
    """One camera's hit points in metres, their mean densities and f16
    features (None when no pixel hits inside the bounds)."""
    dev = cameras["c2w"].device
    rows, cols = np.nonzero(np.ones((H, W), bool))
    index = np.stack([np.full(len(rows), cam, np.int32), rows.astype(np.int32),
                      cols.astype(np.int32)], -1)
    pts, dens, feats = [], [], []
    for s in range(0, len(index), chunk):
        o, d, _, _ = N.generate_rays(cameras, torch.from_numpy(index[s:s + chunk]).to(dev))
        depth = forward_depth(P, model, o, d)[depth_type].cpu().numpy() / psf
        world = o.cpu().numpy() / psf + d.cpu().numpy() * depth[:, None]
        sel = ((depth < max_depth) & (depth > min_depth) & (world[:, 2] > z_bounds[0])
               & (world[:, 2] < z_bounds[1]))
        world = world[sel]
        if len(world) == 0:
            continue
        dn, ft = point_queries(P, model, torch.from_numpy(world.astype(np.float32)).to(dev) * psf)
        pts.append(world.astype(np.float32))
        dens.append(dn.cpu().numpy().astype(np.float32))
        feats.append(ft.cpu().numpy().astype(np.float16))
    if not pts:
        return None
    return np.concatenate(pts), np.concatenate(dens), np.concatenate(feats)


def voxelize(points, colors, features, voxel_size: float, min_bound) -> Dict[str, np.ndarray]:
    """Per-voxel means (float64 sums in arrival order) and hit counts, by
    floor((p - min_bound) / voxel_size), sorted by voxel key."""
    ijk = np.floor((points.astype(np.float64) - min_bound) / voxel_size).astype(np.int64)
    keys = (ijk[:, 0] << 42) | (ijk[:, 1] << 21) | ijk[:, 2]
    uniq, inv = np.unique(keys, return_inverse=True)
    n = len(uniq)
    sums = [np.zeros((n, a.shape[1]), np.float64) for a in (points, colors, features)]
    for acc, a in zip(sums, (points, colors, features)):
        np.add.at(acc, inv, a.astype(np.float64))
    hits = np.bincount(inv, minlength=n).astype(np.int64)
    denom = np.maximum(hits, 1)[:, None].astype(np.float64)
    return {"points": sums[0] / denom, "colors": sums[1] / denom,
            "features": (sums[2] / denom).astype(np.float16), "hits": hits}


def extract(P: Dict, model: Dict, cameras: Dict, H: int, W: int, psf: float, origin,
            dino_to_rgb: Dict, voxel_size: float = 0.4, max_depth: float = 50.0,
            min_depth: float = 0.5, hit_thr_ratio: float = 0.2, depth_type: str = "depth",
            density_threshold: float = 1.0) -> Optional[Dict[str, np.ndarray]]:
    """The prior of the frame's cameras (H x W after scaling)."""
    parts = []
    with torch.no_grad():
        for cam in range(cameras["c2w"].shape[0]):
            found = camera_points(P, model, cameras, cam, H, W, psf, max_depth, min_depth,
                                  depth_type)
            if found is None:
                continue
            pts, dens, feats = found
            sel = dens > density_threshold
            if sel.any():
                parts.append((pts[sel], colormap(feats[sel].astype(np.float32), dino_to_rgb),
                              feats[sel]))
    if not parts:
        min_bound = np.zeros(3, np.float32)
        vox = {"points": np.zeros((0, 3)), "colors": np.zeros((0, 3)),
               "features": np.zeros((0, model["semantic_dim"]), np.float16),
               "hits": np.zeros((0,), np.int64)}
    else:
        pts, cols, feats = (np.concatenate(x) for x in zip(*parts))
        min_bound = pts.min(axis=0) - np.float32(1.0)
        vox = voxelize(pts, cols, feats, voxel_size, min_bound.astype(np.float64))
    if len(vox["hits"]):
        keep = vox["hits"] > np.quantile(vox["hits"], hit_thr_ratio)
        vox = {k: v[keep] for k, v in vox.items()}
    return {"points": vox["points"].astype(np.float32), "features": vox["features"],
            "colors": vox["colors"].astype(np.float32), "hits": vox["hits"],
            "origin": np.asarray(origin, np.float32), "min_bound": min_bound}
