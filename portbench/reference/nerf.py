"""Plain PyTorch reference of the PreSight city-tile NeRF training step.

A frozen plain copy of the model's forward in train mode, its losses, and
Adam with the warm-up multistep schedule, as ``presight_tpu_torch`` at
commit db696f7 defines them:

  * the forward and losses: presight_tpu_torch/models/nerfacto_ms.py
    (``forward``, ``compute_losses``), fields/ingp_field.py,
    fields/prop_field.py, fields/sky_field.py, fields/router.py;
  * the ops: ops/hash_encoding.py (``hash_encode_plain``), ops/math.py,
    ops/rays.py, ops/samplers.py, ops/stepfun.py, ops/losses.py,
    data/cameras.py (``generate_rays``, pinhole only);
  * the step: engine/train_step.py (microbatches, 1/k scaling) and
    engine/optimizers.py (Adam with L2 weight decay, LambdaLR factor).

Every expert-grouped MLP is a loop over experts on rows sorted by expert
(no padded slabs), the hash lookups are gathers whose gradient autograd
scatters, and the volume rendering is a cumsum: no kernel, no cache. The
parameter tree has the port's layout (dicts, per-layer (W (E, in, out),
b (E, out)) pairs, flat 'corner' tables (E * L * T, F)), so one tree of
weights feeds both. Imports nothing of the port.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_HASH_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
_CORNER_BITS = ((1, 1, 1), (1, 0, 1), (0, 0, 1), (0, 1, 1),
                (1, 1, 0), (1, 0, 0), (0, 0, 0), (0, 1, 0))


# ----------------------------------------------------------------- config


def hash_scalings(num_levels: int, min_res: int, max_res: int) -> np.ndarray:
    """Per-level grid resolutions, the power in float32."""
    levels = np.arange(num_levels).astype(np.float32)
    growth = (np.exp((np.log(max_res) - np.log(min_res)) / (num_levels - 1))
              if num_levels > 1 else 1.0)
    return np.floor((np.float32(min_res) * np.float32(growth) ** levels)
                    .astype(np.float32)).astype(np.float32)


def mlp_dims(in_dim: int, num_layers: int, width: int, out_dim: int) -> List[Tuple[int, int]]:
    if num_layers == 1:
        return [(in_dim, out_dim)]
    return [(in_dim, width)] + [(width, width)] * (num_layers - 2) + [(width, out_dim)]


def hash_spec(model: Dict, prop: Optional[int] = None) -> Dict:
    """Levels, resolutions, table size and features of the main field's
    encoding (prop None) or proposal round ``prop``'s."""
    if prop is None:
        return dict(L=model["num_levels"], min_res=model["base_res"], max_res=model["max_res"],
                    log2T=model["log2_hashmap_size"], F=model["features_per_level"])
    args = model["proposal_net_args_list"][min(prop, len(model["proposal_net_args_list"]) - 1)]
    return dict(L=args["num_levels"], min_res=args["base_res"], max_res=args["max_res"],
                log2T=args["log2_hashmap_size"], F=args["features_per_level"])


def param_shapes(model: Dict, num_experts: int, num_cameras: int, num_videos: int) -> Dict:
    """The parameter tree's trainable leaves as (kind, shape, fan_in) and its
    buffers as None, in the port's layout: 'table' U(-1e-4, 1e-4), 'linear'
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), 'normal' N(0, 1)."""
    E = num_experts

    def table(spec):
        return ("table", (E * spec["L"] * (1 << spec["log2T"]), spec["F"]), None)

    def mlp(in_dim, layers, width, out):
        return [(("linear", (E, fi, fo), fi), ("linear", (E, fo), fi))
                for fi, fo in mlp_dims(in_dim, layers, width, out)]

    fs = hash_spec(model)
    app = model["appearance_embed_dim"] + model["video_embed_dim"]
    sem = model["semantic_dim"]
    field = {
        "hash_table": table(fs),
        "base_mlp": mlp(fs["L"] * fs["F"], 2, model["hidden_dim"], 1 + 15 + sem),
        "rgb_head": mlp(16 + 15 + app, 3, model["hidden_dim_color"], 3),
        "aabbs": None, "centroids": None,
        "semantic_head": mlp(sem, 3, 64, sem),
    }
    props = []
    for i in range(model["num_proposal_iterations"]):
        ps = hash_spec(model, i)
        props.append({"hash_table": table(ps), "mlp": mlp(ps["L"] * ps["F"], 2, 64, 1),
                      "aabbs": None, "centroids": None})
    sky = {"rgb_head": mlp(16 + app, model["num_sky_mlp_layers"], model["sky_mlp_dims"], 3),
           "centroids": None,
           "semantic_head": mlp(16, model["num_sky_mlp_layers"], model["sky_mlp_dims"], sem)}
    return {"field": field, "props": props, "sky": sky,
            "appearance_embedding": ("normal", (num_cameras, model["appearance_embed_dim"]), None),
            "video_embedding": ("normal", (num_videos, model["video_embed_dim"]), None)}


def leaf_paths(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """(path, leaf) pairs of a tree of dicts, lists and (w, b) pairs, in order;
    a spec tuple (kind, shape, fan_in) counts as a leaf."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in leaf_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, list) or (isinstance(tree, tuple) and tree and
                                  not isinstance(tree[0], str)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def build_tree(spec, fn):
    """The tree of ``spec`` with each leaf replaced by fn(path, leaf)."""
    def walk(t, prefix):
        if isinstance(t, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, f"{prefix}{i}/") for i, v in enumerate(t)]
        if isinstance(t, tuple) and t and not isinstance(t[0], str):
            return tuple(walk(v, f"{prefix}{i}/") for i, v in enumerate(t))
        return fn(prefix[:-1], t)
    return walk(spec, "")


# ----------------------------------------------------------------- ops


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x):
    return _TruncExp.apply(x)


def clip(x, lo=None, hi=None):
    """min(max(x, lo), hi): half the gradient to x at a tie, as jnp.clip."""
    if lo is not None:
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype, device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype, device=x.device))
    return x


def contract_positions(positions, aabb):
    """AABB to [-1, 1], L-inf contraction, [-2, 2] to [0, 1]; zero outside."""
    p = (positions - aabb[..., 0, :]) / (aabb[..., 1, :] - aabb[..., 0, :]) * 2.0 - 1.0
    mag = torch.amax(torch.abs(p), dim=-1, keepdim=True)
    safe = torch.clamp(mag, min=1e-12)
    p = torch.where(mag < 1.0, p, (2.0 - 1.0 / safe) * (p / safe))
    p = (p + 2.0) / 4.0
    sel = torch.all((p > 0.0) & (p < 1.0), dim=-1)
    return p * sel[..., None], sel


def sh4(d):
    """Real spherical harmonics up to degree 3 (16 values)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full(x.shape, 0.28209479177387814, dtype=d.dtype, device=d.device),
        0.4886025119029199 * y, 0.4886025119029199 * z, 0.4886025119029199 * x,
        1.0925484305920792 * x * y, 1.0925484305920792 * y * z,
        0.9461746957575601 * zz - 0.31539156525251999, 1.0925484305920792 * x * z,
        0.5462742152960396 * (xx - yy), 0.5900435899266435 * y * (3 * xx - yy),
        2.890611442640554 * x * y * z, 0.4570457994644658 * y * (5 * zz - 1),
        0.3731763325901154 * z * (5 * zz - 3), 0.4570457994644658 * x * (5 * zz - 1),
        1.445305721320277 * z * (xx - yy), 0.5900435899266435 * x * (xx - 3 * yy)], dim=-1)


def hash_encode(table, unit, spec, expert_ids):
    """'corner' storage: eight hashed corner rows a level, trilinear blend;
    unit positions (N, 3) in [0, 1] -> (N, L * F)."""
    L, T, F = spec["L"], 1 << spec["log2T"], spec["F"]
    scal = torch.as_tensor(hash_scalings(L, spec["min_res"], spec["max_res"]), device=unit.device)
    scaled = unit[:, None, :] * scal[:, None]
    fl_f = torch.floor(scaled)
    off = scaled - fl_f
    fl = fl_f.to(torch.int64)
    ce = torch.ceil(scaled).to(torch.int64)
    bits = torch.as_tensor(_CORNER_BITS, device=unit.device) == 1  # (8, 3)
    w = torch.where(bits, off[..., None, :], 1.0 - off[..., None, :])
    w = w[..., 0] * w[..., 1] * w[..., 2]  # (N, L, 8)
    c = torch.where(bits, ce[..., None, :], fl[..., None, :])  # (N, L, 8, 3)
    h = (((c[..., 0] * _HASH_PRIMES[0]) & _U32) ^ ((c[..., 1] * _HASH_PRIMES[1]) & _U32)
         ^ ((c[..., 2] * _HASH_PRIMES[2]) & _U32)) & (T - 1)
    idx = (h + (torch.arange(L, device=unit.device) * T)[:, None]
           + (expert_ids.to(torch.int64) * (L * T))[:, None, None])
    out = torch.sum(table[idx] * w[..., None], dim=-2)  # (N, L, F)
    return out.reshape(out.shape[0], L * F)


def assign_experts(positions, centroids):
    """Nearest centroid, first on ties; squared distance summed x, y, z."""
    d = positions[:, None, :] - centroids[None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    return torch.argmin(d2, dim=-1)


def grouped_mlp(layers, x, expert_ids, num_experts: int, sigmoid: bool = False):
    """Each row through its expert's MLP (ReLU between layers)."""
    order = torch.argsort(expert_ids, stable=True)
    counts = torch.bincount(expert_ids, minlength=num_experts).tolist()
    outs = []
    for e, part in enumerate(torch.split(x[order], counts)):
        h = part
        for j, (w, b) in enumerate(layers):
            h = h @ w[e] + b[e]
            if j < len(layers) - 1:
                h = torch.relu(h)
        outs.append(h)
    y = torch.empty_like(order)
    y[order] = torch.arange(order.shape[0], device=order.device)
    out = torch.cat(outs)[y]
    return torch.sigmoid(out) if sigmoid else out


def get_weights(deltas, densities):
    dd = deltas * densities
    alphas = 1.0 - torch.exp(-dd)
    csum = torch.cat([torch.zeros_like(dd[..., :1]), torch.cumsum(dd[..., :-1], dim=-1)], -1)
    return torch.nan_to_num(alphas * torch.exp(-csum))


# ----------------------------------------------------------------- sampling


def spacing_fn(t, thr):
    return torch.where(t < thr, t / (2.0 * thr), 1.0 - thr / (2.0 * torch.clamp(t, min=1e-12)))


def spacing_inv(s, thr):
    return torch.where(s < 0.5, s * (2.0 * thr), thr / torch.clamp(2.0 - 2.0 * s, min=1e-12))


def _samples(nears, fars, bins, thr):
    s_near, s_far = spacing_fn(nears, thr)[..., None], spacing_fn(fars, thr)[..., None]
    eu = spacing_inv(bins * s_far + (1.0 - bins) * s_near, thr)
    return {"starts": eu[..., :-1], "ends": eu[..., 1:], "sdist": bins}


def spaced_sample(nears, fars, num, thr, uniform=None):
    """Bins under the spacing warp: jittered by ``uniform`` (R, 1), or at
    linspace(0, 1) with None (serving)."""
    bins = torch.linspace(0.0, 1.0, num + 1, device=nears.device)[None, :]
    if uniform is None:
        return _samples(nears, fars, bins.expand(nears.shape[0], num + 1), thr)
    centers = (bins[..., 1:] + bins[..., :-1]) / 2.0
    upper = torch.cat([centers, bins[..., -1:]], -1)
    lower = torch.cat([bins[..., :1], centers], -1)
    return _samples(nears, fars, lower + (upper - lower) * uniform, thr)


def pdf_sample(nears, fars, prev, weights, num, thr, uniform, eps, padding=0.01):
    """Inverse-CDF resampling; ``uniform`` None takes the midpoint rule."""
    nb = num + 1
    w = weights + padding
    w_sum = torch.sum(w, dim=-1, keepdim=True)
    pad = torch.relu(eps - w_sum)
    w = w + pad / w.shape[-1]
    pdf = w / (w_sum + pad)
    cdf = torch.clamp(torch.cumsum(pdf, dim=-1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    u = torch.linspace(0.0, 1.0 - 1.0 / nb, nb, device=weights.device).expand(*cdf.shape[:-1], nb)
    u = (u + (1.0 / (2 * nb) if uniform is None else uniform / nb)).contiguous()
    existing = prev["sdist"]
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, 0, existing.shape[-1] - 1)
    above = torch.clamp(inds, 0, existing.shape[-1] - 1)
    c0, c1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    b0, b1 = torch.gather(existing, -1, below), torch.gather(existing, -1, above)
    t = torch.clamp(torch.nan_to_num((u - c0) / (c1 - c0)), 0.0, 1.0)
    return _samples(nears, fars, (b0 + t * (b1 - b0)).detach(), thr)


def positions(origins, directions, s):
    mids = (s["starts"] + s["ends"]) / 2.0
    return origins[:, None, :] + directions[:, None, :] * mids[..., None]


# ----------------------------------------------------------------- losses


def lossfun_distortion(t, w):
    ut = (t[..., 1:] + t[..., :-1]) / 2.0
    cw = torch.cumsum(w, dim=-1) - w
    cwu = torch.cumsum(w * ut, dim=-1) - w * ut
    return (2.0 * torch.sum(w * (ut * cw - cwu), dim=-1)
            + torch.sum(w ** 2 * (t[..., 1:] - t[..., :-1]), dim=-1) / 3.0)


def blur_stepfun(x, y, r):
    xr_cat = torch.cat([x - r, x + r], dim=-1)
    zero = torch.zeros_like(y[..., :1])
    y1 = (torch.cat([y, zero], -1) - torch.cat([zero, y], -1)) / (2.0 * r)
    xr, order = torch.sort(xr_cat, dim=-1, stable=True)
    y2 = torch.gather(torch.cat([y1, -y1], -1), -1, order)[..., :-1]
    yr = clip(torch.cumsum((xr[..., 1:] - xr[..., :-1]) * torch.cumsum(y2, dim=-1), dim=-1), 0.0)
    return xr, torch.cat([torch.zeros_like(yr[..., :1]), yr], -1)


def sorted_interp_quad(x, xp, fpdf, fcdf):
    last = xp.shape[-1] - 1
    ir = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True)
    i0, i1 = torch.clamp(ir - 1, 0, last), torch.clamp(ir, 0, last)
    g = lambda a, i: torch.gather(a, -1, i)  # noqa: E731
    xp0, xp1 = g(xp, i0), g(xp, i1)
    off = clip(torch.nan_to_num((x - xp0) / (xp1 - xp0)), 0.0, 1.0)
    return g(fcdf, i0) + (x - xp0) * (g(fpdf, i0) + g(fpdf, i1) * off
                                      + g(fpdf, i0) * (1.0 - off)) / 2.0


def z_aa_interlevel(weights_list, sdist_list, pulse_width):
    c = sdist_list[-1].detach()
    w = weights_list[-1].detach()
    wn = w / (c[..., 1:] - c[..., :-1])
    loss = 0.0
    for i, (cp, wp) in enumerate(zip(sdist_list[:-1], weights_list[:-1])):
        cb, wb = blur_stepfun(c, wn, pulse_width[i])
        area = 0.5 * (wb[..., 1:] + wb[..., :-1]) * (cb[..., 1:] - cb[..., :-1])
        cdf = torch.cat([torch.zeros_like(area[..., :1]), torch.cumsum(area, -1)], -1)
        w_s = torch.diff(sorted_interp_quad(cp, cb, wb, cdf), dim=-1)
        loss = loss + torch.mean(clip(w_s - wp, 0.0) ** 2 / (wp + 1e-5))
    return loss


# ----------------------------------------------------------------- model


def generate_rays(cameras: Dict, ray_index):
    """Pinhole rays of (camera, row, col) triples, pixel centres at +0.5."""
    cam = ray_index[:, 0].long()
    y = ray_index[:, 1].to(torch.float32) + 0.5
    x = ray_index[:, 2].to(torch.float32) + 0.5
    u = (x - cameras["cx"][cam]) / cameras["fx"][cam]
    v = -(y - cameras["cy"][cam]) / cameras["fy"][cam]
    c2w = cameras["c2w"][cam]
    d = torch.einsum("rij,rj->ri", c2w[:, :3, :3], torch.stack([u, v, -torch.ones_like(u)], -1))
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return c2w[:, :3, 3], d, cam, cameras["video_ids"][cam].long()


def prop_density(p, spec, pos, E):
    flat = pos.reshape(-1, 3)
    e = assign_experts(flat, p["centroids"])
    unit, sel = contract_positions(flat, p["aabbs"][e])
    feats = hash_encode(p["hash_table"], unit, spec, e)
    logit = grouped_mlp(p["mlp"], feats, e, E)[:, 0]
    return (trunc_exp(logit) * sel).reshape(pos.shape[:-1])


def field_outputs(P: Dict, model: Dict, origins, directions, cam, vid, s: Dict) -> Dict:
    """The main field at the final round's samples ``s``: its weights, the
    rgb and semantics composites blended with the sky, the accumulation."""
    f = P["field"]
    E = f["centroids"].shape[0]
    R, S = s["starts"].shape
    flat = positions(origins, directions, s).reshape(-1, 3)
    e = assign_experts(flat, f["centroids"])
    unit, sel = contract_positions(flat, f["aabbs"][e])
    h = grouped_mlp(f["base_mlp"], hash_encode(f["hash_table"], unit, hash_spec(model), e), e, E)
    density = (trunc_exp(h[:, 0]) * sel).reshape(R, S)
    geo, sem_emb = h[:, 1:16], h[:, 16:]
    app = torch.cat([P["appearance_embedding"][cam], P["video_embedding"][vid]], -1)
    dirs = directions[:, None, :].expand(R, S, 3).reshape(-1, 3)
    rgb_in = torch.cat([sh4(dirs), geo, app[:, None, :].expand(R, S, app.shape[-1])
                        .reshape(R * S, -1)], -1)
    rgb_s = grouped_mlp(f["rgb_head"], rgb_in, e, E, sigmoid=True)
    sem_s = grouped_mlp(f["semantic_head"], sem_emb, e, E)
    weights = get_weights(s["ends"] - s["starts"], density)
    payload = torch.cat([rgb_s, sem_s], -1).reshape(R, S, -1)
    comp = torch.sum(payload * weights[..., None], dim=1)
    acc = clip(torch.sum(weights, -1), 0.0, 1.0)
    sky = P["sky"]
    se = assign_experts(origins, sky["centroids"])
    d_enc = sh4(directions)
    sky_rgb = grouped_mlp(sky["rgb_head"], torch.cat([d_enc, app], -1), se,
                          sky["centroids"].shape[0], sigmoid=True)
    sky_sem = grouped_mlp(sky["semantic_head"], d_enc, se, sky["centroids"].shape[0])
    return {"rgb": comp[:, :3] + (1.0 - acc)[:, None] * sky_rgb,
            "semantics": comp[:, 3:] + (1.0 - acc)[:, None] * sky_sem,
            "accumulation": acc, "weights": weights}


def forward(P: Dict, model: Dict, origins, directions, cam, vid, uniforms, anneal: float,
            stop_prop_grad: bool, record=None) -> Dict:
    """The train-mode forward of a microbatch of rays. ``record(samples,
    out)``, where given, sees each round's samples and the outputs."""
    E = P["field"]["centroids"].shape[0]
    R = origins.shape[0]
    thr = model["piecewise_sampler_threshold"]
    nears = torch.full((R,), model["near_plane"], device=origins.device)
    fars = torch.full((R,), model["far_plane"], device=origins.device)
    eps = float(torch.finfo(torch.float32).eps)
    n_prop = len(model["num_proposal_samples_per_ray"])
    weights_list, sdist_list, samples = [], [], []
    s = w = None
    for lvl in range(n_prop + 1):
        num = (model["num_proposal_samples_per_ray"][lvl] if lvl < n_prop
               else model["num_nerf_samples_per_ray"])
        if lvl == 0:
            s = spaced_sample(nears, fars, num, thr, uniforms[lvl])
        else:
            s = pdf_sample(nears, fars, s, torch.pow(w, anneal), num, thr, uniforms[lvl], eps)
        samples.append(s)
        if lvl < n_prop:
            dens = prop_density(P["props"][lvl], hash_spec(model, lvl),
                                positions(origins, directions, s), E)
            if stop_prop_grad:
                dens = dens.detach()
            w = get_weights(s["ends"] - s["starts"], dens)
            weights_list.append(w)
            sdist_list.append(s["sdist"])
    out = field_outputs(P, model, origins, directions, cam, vid, s)
    weights_list.append(out.pop("weights"))
    sdist_list.append(s["sdist"])
    out.update(weights_list=weights_list, sdist_list=sdist_list,
               steps=(s["starts"] + s["ends"]) / 2.0)
    if record is not None:
        record(samples, out)
    return out


@torch.no_grad()
def outputs_at(P: Dict, model: Dict, origins, directions, cam, vid,
               samples: Sequence[Dict]) -> Dict:
    """The forward's outputs at given samples of every round (dicts of
    starts and ends): each round's weights, the composites and the
    accumulation, with no sampling of its own."""
    E = P["field"]["centroids"].shape[0]
    weights_list = [get_weights(s["ends"] - s["starts"],
                                prop_density(P["props"][lvl], hash_spec(model, lvl),
                                             positions(origins, directions, s), E))
                    for lvl, s in enumerate(samples[:-1])]
    out = field_outputs(P, model, origins, directions, cam, vid, samples[-1])
    weights_list.append(out.pop("weights"))
    out["weights_list"] = weights_list
    return out


def losses(out: Dict, batch: Dict, model: Dict) -> Dict[str, torch.Tensor]:
    """The camera-only tile's losses: rgb, sky, semantic, anti-aliased
    interlevel and distortion (no depth supervision)."""
    acc = clip(out["accumulation"], 1e-7, 1.0 - 1e-7)
    target = 1.0 - batch["sky"]
    sky = torch.mean(-(target * torch.log(acc) + (1.0 - target) * torch.log(1.0 - acc)))
    return {
        "rgb_loss": torch.mean((out["rgb"] - batch["rgb"]) ** 2),
        "sky_loss": model["sky_loss_mult"] * sky,
        "semantic_loss": model["semantic_loss_mult"] * torch.mean(
            (out["semantics"] - clip(batch["features"], 0.0, 1.0)) ** 2),
        "interlevel_loss": model["interlevel_loss_mult"] * z_aa_interlevel(
            out["weights_list"], out["sdist_list"], model["pulse_width"]),
        "distortion_loss": model["distortion_loss_mult"] * torch.mean(
            lossfun_distortion(out["sdist_list"][-1], out["weights_list"][-1])),
    }


# ----------------------------------------------------------------- schedules


def anneal_at(model: Dict, step: int) -> float:
    frac = float(np.clip(step / model["proposal_weights_anneal_max_num_iters"], 0.0, 1.0))
    b = model["proposal_weights_anneal_slope"]
    return float(np.float32(b * frac / ((b - 1.0) * frac + 1.0)))


def proposal_updates(model: Dict, steps: int) -> List[bool]:
    """Whether each of steps 0..steps-1 of an uninterrupted run carries the
    proposal gradient."""
    since, out = 0, []
    for step in range(steps):
        sched = float(np.clip(np.interp(step, [0, model["proposal_warmup"]],
                                        [0, model["proposal_update_every"]]),
                              1, model["proposal_update_every"]))
        up = bool(since > sched or step < 10)
        out.append(up)
        since = 1 if up else since + 1
    return out


def lr_factor(opt: Dict, step: int) -> float:
    f32 = np.float32
    t = f32(max(opt["warmup_steps"], 1))
    warm = f32(opt["warmup_start_factor"]) + (f32(1.0) - f32(opt["warmup_start_factor"])) * \
        np.minimum(f32(step), t) / t
    return float(warm * f32(opt["gamma"]) ** f32(sum(step >= m for m in opt["milestones"])))


# ----------------------------------------------------------------- training


class Adam:
    """torch.optim.Adam's arithmetic (L2 weight decay into the gradient,
    bias-corrected moments, eps outside the root), one state per leaf."""

    def __init__(self, leaves: Sequence[torch.Tensor], lr: float, eps: float, wd: float,
                 betas=(0.9, 0.999)):
        self.leaves, self.lr, self.eps, self.wd = list(leaves), lr, eps, wd
        self.b1, self.b2 = betas
        self.m = [torch.zeros_like(p) for p in self.leaves]
        self.v = [torch.zeros_like(p) for p in self.leaves]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], factor: float) -> List[torch.Tensor]:
        """Update the leaves; returns the gradients as the moments took them."""
        self.t += 1
        lr = self.lr * factor
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        taken = []
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            g = g + self.wd * p
            taken.append(g)
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.addcdiv_(m, v.sqrt() / math.sqrt(bc2) + self.eps, value=-lr / bc1)
        return taken


def train_steps(P: Dict, groups: Dict[str, List[str]], model: Dict, trainer: Dict,
                cameras: Dict, batches: Sequence[Dict], start_step: int,
                generator: torch.Generator, on_first_grads=None,
                on_first_forward=None) -> List[float]:
    """Steps start_step.. over ``batches`` (one dict of ray_index, rgb, sky,
    features a step), updating the tree P in place; ``groups`` names each
    optimizer group's leaf paths. Returns each step's total loss; calls
    on_first_grads({path: gradient as Adam took it}) after the first, and
    on_first_forward(origins, directions, cam, vid, samples, out) after the
    first microbatch's forward."""
    leaves = dict(leaf_paths(P))
    for path in (p for g in groups.values() for p in g):
        leaves[path].requires_grad_(True)
    opts = {name: Adam([leaves[p] for p in paths], trainer["optimizers"][name]["lr"],
                       trainer["optimizers"][name]["eps"],
                       trainer["optimizers"][name]["weight_decay"])
            for name, paths in groups.items()}
    rays, micro = trainer["train_num_rays_per_batch"], trainer["microbatch_rays"]
    k = rays // micro
    updates = proposal_updates(model, start_step + len(batches))
    rounds = len(model["num_proposal_samples_per_ray"]) + 1
    totals = []
    for i, batch in enumerate(batches):
        step = start_step + i
        for p in leaves.values():
            p.grad = None
        total = 0.0
        for j in range(k):
            chunk = {key: v[j * micro:(j + 1) * micro] for key, v in batch.items()}
            uniforms = [torch.rand((micro, 1), generator=generator, device=generator.device)
                        for _ in range(rounds)]
            o, d, cam, vid = generate_rays(cameras, chunk["ray_index"])
            record = (None if on_first_forward is None or i or j else
                      lambda samples, out: on_first_forward(o, d, cam, vid, samples, out))
            out = forward(P, model, o, d, cam, vid, uniforms, anneal_at(model, step),
                          stop_prop_grad=not updates[step], record=record)
            loss = sum(losses(out, chunk, model).values())
            loss.backward()
            total += float(loss.detach())
        totals.append(total / k)
        for name, paths in groups.items():
            grads = [leaves[p].grad / k if leaves[p].grad is not None
                     else torch.zeros_like(leaves[p]) for p in paths]
            taken = opts[name].step(grads, lr_factor(trainer["optimizers"][name], step))
            if i == 0 and on_first_grads is not None:
                on_first_grads(dict(zip(paths, taken)))
    for p in leaves.values():
        p.grad = None
        p.requires_grad_(False)
    return totals
