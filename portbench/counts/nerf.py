"""Work of the city-tile NeRF training step, counted from its shapes.

Model FLOPs are the multiply-adds of the MLPs (2 FLOPs each), the work
that every implementation has to do; the hash lookups, the sampling and
the volume rendering are left out (a few per cent of the matmul count, and
memory-bound). A row of an MLP with layers (in_i, out_i) costs
2 * sum(in_i * out_i) forward and twice that backward: dX and dW take one
product each. Every input carries a gradient (the hash tables, the
geometry and semantic embeddings, the appearance embeddings) but the sky's
semantic head's, the directions' harmonics alone: its first layer takes
dW and no dX. Rows: the main field and its heads take one per final sample
(rays * num_nerf_samples), proposal round i one per round-i sample, the
sky one per ray. The proposal fields' backward runs only on the steps
that carry the proposal gradient.

The table gradient (``_HashEncode.backward``: the rows' cotangents to the
tables) reads, once, each sample's position (12 bytes), expert id (4) and
cotangent (L * F * 4 bytes), and writes each gradient row it touches
(F * 4 bytes). A level of an expert holds at most min(T, (res + 1)^3)
distinct corners, and the samples touch at most 8 per sample, so the rows
written are counted as min(8 * samples, E * min(T, (res + 1)^3)) a level:
the most the data can touch, which the sample positions decide. Its FLOPs
are the eight trilinear weights (two products each) and the F products of
each weight with the cotangent, per sample, level and corner.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def mlp_dims(in_dim: int, num_layers: int, width: int, out_dim: int) -> List[Tuple[int, int]]:
    if num_layers == 1:
        return [(in_dim, out_dim)]
    return [(in_dim, width)] + [(width, width)] * (num_layers - 2) + [(width, out_dim)]


def mlp_row_flops(dims: List[Tuple[int, int]]) -> int:
    """Forward FLOPs of one row."""
    return 2 * sum(i * o for i, o in dims)


def _prop_args(model: Dict, i: int) -> Dict:
    args = model["proposal_net_args_list"]
    return args[min(i, len(args) - 1)]


def forward_flops_per_ray(model: Dict) -> Dict[str, int]:
    """Forward MLP FLOPs of one ray by part: 'field', 'props', 'sky'."""
    S = model["num_nerf_samples_per_ray"]
    sem = model["semantic_dim"]
    app = model["appearance_embed_dim"] + model["video_embed_dim"]
    enc = model["num_levels"] * model["features_per_level"]
    field = (mlp_row_flops(mlp_dims(enc, 2, model["hidden_dim"], 1 + 15 + sem))
             + mlp_row_flops(mlp_dims(16 + 15 + app, 3, model["hidden_dim_color"], 3))
             + mlp_row_flops(mlp_dims(sem, 3, 64, sem))) * S
    props = 0
    for i, n in enumerate(model["num_proposal_samples_per_ray"]):
        a = _prop_args(model, i)
        props += mlp_row_flops(mlp_dims(a["num_levels"] * a["features_per_level"], 2, 64, 1)) * n
    L, W = model["num_sky_mlp_layers"], model["sky_mlp_dims"]
    sky = mlp_row_flops(mlp_dims(16 + app, L, W, 3)) + mlp_row_flops(mlp_dims(16, L, W, sem))
    return {"field": field, "props": props, "sky": sky}


def train_step_flops(model: Dict, rays: int, proposal_grad: bool) -> int:
    """Model FLOPs of one training step of ``rays`` rays."""
    f = forward_flops_per_ray(model)
    sky_sem_first = mlp_row_flops(mlp_dims(16, model["num_sky_mlp_layers"],
                                           model["sky_mlp_dims"], model["semantic_dim"])[:1])
    backward = (2 * (f["field"] + f["sky"] + (f["props"] if proposal_grad else 0))
                - sky_sem_first)
    return rays * (sum(f.values()) + backward)


def depth_flops(model: Dict, rays: int) -> int:
    """MLP FLOPs of the depth render of ``rays`` rays (extraction's
    ``forward_depth``): every proposal round, and the main field's base
    MLP (density only). The point queries at the hits, at most one a ray,
    depend on the data and are left out."""
    props = forward_flops_per_ray(model)["props"]
    enc = model["num_levels"] * model["features_per_level"]
    base = mlp_row_flops(mlp_dims(enc, 2, model["hidden_dim"], 1 + 15 + model["semantic_dim"]))
    return rays * (props + base * model["num_nerf_samples_per_ray"])


def _resolutions(L: int, min_res: int, max_res: int) -> np.ndarray:
    levels = np.arange(L).astype(np.float32)
    growth = np.exp((np.log(max_res) - np.log(min_res)) / (L - 1)) if L > 1 else 1.0
    return np.floor((np.float32(min_res) * np.float32(growth) ** levels).astype(np.float32))


def table_grad_work(samples: int, experts: int, L: int, F: int, log2T: int, min_res: int,
                    max_res: int) -> Tuple[float, float]:
    """(bytes, FLOPs) of one hash encoding's table gradient over ``samples``."""
    read = samples * (12 + 4 + L * F * 4)
    T = 1 << log2T
    rows = sum(min(8 * samples, experts * min(T, (int(r) + 1) ** 3))
               for r in _resolutions(L, min_res, max_res))
    flops = samples * L * 8 * (2 + F)
    return float(read + rows * F * 4), float(flops)


def table_grad_step(model: Dict, experts: int, rays: int, micro: int,
                    proposal_grad: bool) -> Tuple[float, float]:
    """(bytes, FLOPs) of one step's table gradients: each microbatch's main
    field, and its proposal rounds on steps with the proposal gradient."""
    k = rays // micro
    by, fl = table_grad_work(micro * model["num_nerf_samples_per_ray"], experts,
                             model["num_levels"], model["features_per_level"],
                             model["log2_hashmap_size"], model["base_res"], model["max_res"])
    if proposal_grad:
        for i, n in enumerate(model["num_proposal_samples_per_ray"]):
            a = _prop_args(model, i)
            b2, f2 = table_grad_work(micro * n, experts, a["num_levels"],
                                     a["features_per_level"], a["log2_hashmap_size"],
                                     a["base_res"], a["max_res"])
            by, fl = by + b2, fl + f2
    return k * by, k * fl
