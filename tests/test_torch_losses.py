"""The port's losses, step-function math and compute_losses
(presight_tpu_torch.ops.losses, ops.stepfun, models.nerfacto_ms) against
the JAX package: values, and gradients by torch.autograd against jax.grad,
on every branch of compute_losses (rgb, sky, semantic, lidar and monodepth
depth with line of sight, z-AA and plain interlevel, distortion).

The accumulations include exact 0.0 and 1.0, where jnp.clip passes half the
gradient; the port's clip does the same. Tolerances: values rtol 1e-5 +
atol 1e-7; gradients rtol 1e-4 + atol 1e-6 times the largest gradient of
the leaf (the cumsums and reductions add in another order than XLA's).
JAX functions are jitted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presight_tpu.models import nerfacto_ms as JM
from presight_tpu.ops import rays as JRays
from presight_tpu.ops import stepfun as JSF
from presight_tpu_torch import configs as TCfg
from presight_tpu_torch.models import nerfacto_ms as TM
from presight_tpu_torch.ops import hash_encoding as THE
from presight_tpu_torch.ops import rays as TRays
from presight_tpu_torch.ops import stepfun as TSF

R, P, S, D = 48, 12, 8, 6
KEYS = ("rgb", "accumulation", "expected_depth", "semantics", "w_prop", "w")


def _samples(rng, n, s, lo=0.005, hi=50.0):
    spacing = np.sort(rng.rand(n, s + 1).astype(np.float32), axis=-1)
    spacing[:, 0], spacing[:, -1] = 0.0, 1.0
    edges = (lo + spacing * (hi - lo)).astype(np.float32)
    o = rng.randn(n, 3).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    return dict(starts=edges[:, :-1], ends=edges[:, 1:], spacing_starts=spacing[:, :-1],
                spacing_ends=spacing[:, 1:], origins=o, directions=d)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    w = (rng.rand(R, S) ** 3 * 0.3).astype(np.float32)
    w_prop = (rng.rand(R, P) ** 2 * 0.2).astype(np.float32)
    acc = rng.rand(R).astype(np.float32)
    acc[:4] = [0.0, 1.0, 1e-7, 1.0 - 1e-7]  # empty, saturated and at the sky clip
    vals = dict(rgb=rng.rand(R, 3).astype(np.float32), accumulation=acc,
                expected_depth=(rng.rand(R) * 4.0).astype(np.float32),
                semantics=rng.rand(R, D).astype(np.float32), w_prop=w_prop, w=w)
    depth = (rng.rand(R) * 90.0 - 5.0).astype(np.float32)
    batch = dict(rgb=rng.rand(R, 3).astype(np.float32),
                 sky=(rng.rand(R) < 0.3).astype(np.float32), depth=depth,
                 features=(rng.rand(R, D) * 1.4 - 0.2).astype(np.float32))
    return vals, batch, _samples(rng, R, P), _samples(rng, R, S)


def _jax_losses(jcfg):
    def fn(vals, batch, sp, sf, sigma, los_mult):
        outputs = dict(vals)
        outputs["weights_list"] = [vals["w_prop"], vals["w"]]
        outputs["ray_samples_list"] = [JRays.RaySamples(**sp), JRays.RaySamples(**sf)]
        return JM.compute_losses(outputs, batch, jcfg, sigma, los_mult)

    def total(vals, *args):
        return sum(fn(vals, *args).values())

    return jax.jit(fn), jax.jit(jax.grad(total))


def _port_losses(tcfg, vals, batch, sp, sf, sigma, los_mult):
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in vals.items()}
    outputs = dict(t)
    outputs["weights_list"] = [t["w_prop"], t["w"]]
    outputs["ray_samples_list"] = [TRays.RaySamples(**{k: torch.from_numpy(v) for k, v in sp.items()}),
                                   TRays.RaySamples(**{k: torch.from_numpy(v) for k, v in sf.items()})]
    losses = TM.compute_losses(outputs, {k: torch.from_numpy(v) for k, v in batch.items()},
                               tcfg, sigma, los_mult)
    sum(losses.values()).backward()
    return losses, {k: torch.zeros_like(v) if v.grad is None else v.grad for k, v in t.items()}


BRANCHES = {
    "camera": dict(use_lidar_loss=False),
    "lidar": dict(use_lidar_loss=True, enable_z_anti_aliasing=False),
    "monodepth": dict(use_lidar_loss=False, use_monodepth_loss=True,
                      monodepth_depth_upperbound=25.0),
    "monodepth_inverse": dict(use_lidar_loss=False, use_monodepth_loss=True,
                              monodepth_loss_inverse=True),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_compute_losses_values_and_grads_match_jax(branch):
    common = dict(semantic_dim=D, pose_scale_factor=0.05, prop_grid_res=8,
                  num_proposal_samples_per_ray=(16, P), num_nerf_samples_per_ray=S,
                  **BRANCHES[branch])
    jcfg, tcfg = JM.NerfactoNuscMSConfig(**common), TCfg.NerfactoNuscMSConfig(**common)
    vals, batch, sp, sf = _inputs()
    sigma, los_mult = np.float32(2.5), np.float32(0.1)
    fn, grad = _jax_losses(jcfg)
    jargs = ({k: jnp.asarray(v) for k, v in vals.items()},
             {k: jnp.asarray(v) for k, v in batch.items()},
             {k: jnp.asarray(v) for k, v in sp.items()},
             {k: jnp.asarray(v) for k, v in sf.items()}, sigma, los_mult)
    ref, ref_grads = fn(*jargs), grad(*jargs)
    losses, grads = _port_losses(tcfg, vals, batch, sp, sf, float(sigma), float(los_mult))
    assert set(losses) == set(ref)
    if branch != "camera":
        assert {"expected_depth_loss", "line_of_sight_loss"} <= set(losses)
    for key, v in ref.items():
        np.testing.assert_allclose(losses[key].detach().numpy(), np.asarray(v), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    for key in KEYS:
        want = np.asarray(ref_grads[key])
        got = grads[key].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * np.abs(want).max(),
                                   err_msg=key)
    # Rays 2 and 3 sit exactly on sky_loss's clip bounds (eps, 1 - eps),
    # where half the gradient passes, in both packages.
    assert (np.abs(np.asarray(ref_grads["accumulation"])[2:4]) > 0.0).all()


def test_stepfun_pieces_match_jax():
    """blur_stepfun, sorted_interp_quad, lossfun_outer and
    lossfun_distortion on their own: rtol 1e-5 + atol 1e-6, except the
    blurred step values and the CDF interpolated from them, atol 1e-5 of
    their largest value (a cumsum of products of a cumsum: each value is a
    difference of large partial sums, which XLA and torch add in other
    orders)."""
    vals, _, sp, sf = _inputs(seed=1)
    c, w = sf["spacing_starts"], vals["w"]
    c = np.concatenate([c, sf["spacing_ends"][:, -1:]], -1)
    cp = np.concatenate([sp["spacing_starts"], sp["spacing_ends"][:, -1:]], -1)
    wn = w / (c[:, 1:] - c[:, :-1])

    def jax_fn(c, w, wn, cp, wp):
        cb, wb = JSF.blur_stepfun(c, wn, 0.03)
        area = 0.5 * (wb[..., 1:] + wb[..., :-1]) * (cb[..., 1:] - cb[..., :-1])
        cdf = jnp.concatenate([jnp.zeros_like(area[..., :1]), jnp.cumsum(area, -1)], -1)
        return (cb, wb, JSF.sorted_interp_quad(cp, cb, wb, cdf), JSF.lossfun_outer(c, w, cp, wp),
                JSF.lossfun_distortion(c, w))

    ref = jax.jit(jax_fn)(*(jnp.asarray(a) for a in (c, w, wn, cp, vals["w_prop"])))
    t = [torch.from_numpy(a) for a in (c, w, wn, cp, vals["w_prop"])]
    cb, wb = TSF.blur_stepfun(t[0], t[2], 0.03)
    area = 0.5 * (wb[..., 1:] + wb[..., :-1]) * (cb[..., 1:] - cb[..., :-1])
    cdf = torch.cat([torch.zeros_like(area[..., :1]), torch.cumsum(area, -1)], -1)
    got = (cb, wb, TSF.sorted_interp_quad(t[3], cb, wb, cdf), TSF.lossfun_outer(t[0], t[1], t[3], t[4]),
           TSF.lossfun_distortion(t[0], t[1]))
    for name, a, b in zip(("blur x", "blur y", "interp", "outer", "distortion"), got, ref):
        b = np.asarray(b)
        atol = 1e-5 * np.abs(b).max() if name in ("blur y", "interp") else 1e-6
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=atol, err_msg=name)


def _clip_with_tensor_bounds(x, lo, hi):
    """ops.math.clip with each number bound made a tensor from the host."""
    if lo is not None:
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype))
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype))
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (1e-7, 1.0 - 1e-7), (None, 0.5), (0.25, None)])
def test_clip_with_number_bounds_matches_jnp_clip(lo, hi, dtype):
    """clip with Python-number bounds, filled on x's device: the values and
    the gradient of bounds made tensors from the host, bit for bit, and in
    float32 jnp.clip's under jax.grad: at a tie with a bound half the
    gradient passes."""
    from presight_tpu_torch.ops.math import clip

    rng = np.random.RandomState(7)
    ties = [b for b in (lo, hi) if b is not None]
    x = np.concatenate([rng.rand(40) * 1.6 - 0.3, np.repeat(ties, 3)]).astype(
        torch.empty((), dtype=dtype).numpy().dtype)
    w = rng.randn(len(x)).astype(x.dtype)
    out = []
    for fn in (clip, _clip_with_tensor_bounds):
        t = torch.from_numpy(x).requires_grad_(True)
        y = fn(t, lo, hi)
        (y * torch.from_numpy(w)).sum().backward()
        out.append((y.detach(), t.grad))
    (got, got_grad), (want, want_grad) = out
    assert got.dtype == dtype and torch.equal(got, want) and torch.equal(got_grad, want_grad)
    tie = np.isin(x, np.asarray(ties, x.dtype))
    np.testing.assert_array_equal(got_grad.numpy()[tie], w[tie] / 2)
    if dtype == torch.float32:
        ref = jax.grad(lambda a: jnp.sum(jnp.clip(a, lo, hi) * w))(jnp.asarray(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.clip(jnp.asarray(x), lo, hi)))
        np.testing.assert_array_equal(got_grad.numpy(), np.asarray(ref))


def test_segment_sum_plain_matches_jax():
    """K5's plain version (sorted_accum_plain) against jax.ops.segment_sum
    over sorted keys, accumulating into a non-zero table."""
    rng = np.random.RandomState(2)
    keys = np.sort(rng.randint(0, 300, 2000)).astype(np.int32)
    rows = rng.randn(2000, 5).astype(np.float32)
    base = rng.randn(400, 5).astype(np.float32)
    ref = base + np.asarray(jax.jit(lambda r, k: jax.ops.segment_sum(
        r, k, num_segments=400, indices_are_sorted=True))(jnp.asarray(rows), jnp.asarray(keys)))
    out = torch.from_numpy(base.copy())
    THE.sorted_accum(torch.from_numpy(keys), torch.from_numpy(rows), out, torch.arange(2000))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("parts", [1, 3])
def test_segment_sum_plain_through_order_matches_jax(parts):
    """K5's plain version with the permutation of a stable sort (sorted row
    i is rows[order[i]]) into a non-zero output of one or three parts (part
    p holds keys [p T, (p + 1) T)) against jax.ops.segment_sum over the
    sorted rows plus the prior value."""
    rng = np.random.RandomState(5)
    T, n = 100, 1500
    unsorted = rng.randint(0, parts * T, n).astype(np.int32)
    rows = rng.randn(n, 4).astype(np.float32)
    base = rng.randn(parts * T, 4).astype(np.float32)
    keys, order = torch.sort(torch.from_numpy(unsorted), stable=True)
    ref = base + np.asarray(jax.jit(lambda r, k: jax.ops.segment_sum(
        r, k, num_segments=parts * T, indices_are_sorted=True))(
            jnp.asarray(rows[order.numpy()]), jnp.asarray(keys.numpy())))
    out = torch.from_numpy(base.copy())
    THE.sorted_accum(keys, torch.from_numpy(rows), list(out.split(T)) if parts > 1 else out,
                     order)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_schedules_match_jax():
    cfg = dict(proposal_warmup=50, proposal_update_every=5, line_of_sight_start_step=10,
               line_of_sight_end_step=200, line_of_sight_decay_steps=60,
               proposal_weights_anneal_max_num_iters=40, prop_grid_res=8,
               prop_grid_warmup_steps=30, prop_grid_warmup_every=4, prop_grid_update_every=16)
    jcfg, tcfg = JM.NerfactoNuscMSConfig(**cfg), TCfg.NerfactoNuscMSConfig(**cfg)
    js, ts = JM.ProposalUpdateSchedule(jcfg), TM.ProposalUpdateSchedule(tcfg)
    for step in range(0, 260, 3):
        assert TM.anneal_at(tcfg, step) == JM.anneal_at(jcfg, step)
        assert TM.line_of_sight_sigma_at(tcfg, step) == JM.line_of_sight_sigma_at(jcfg, step)
        assert TM.line_of_sight_mult_at(tcfg, step) == JM.line_of_sight_mult_at(jcfg, step)
        assert TM.prop_grid_refresh_due(tcfg, step) == JM.prop_grid_refresh_due(jcfg, step)
        u = js.updated(step)
        assert ts.updated(step) == u
        js.step_cb(step, u)
        ts.step_cb(step, u)
    off = dataclasses.replace(tcfg, use_proposal_weight_anneal=False)
    assert TM.anneal_at(off, 5) == 1.0
