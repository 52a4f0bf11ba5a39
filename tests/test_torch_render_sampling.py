"""K3's module (presight_tpu_torch.ops.renderers, with ops.rays), K4's module
(presight_tpu_torch.fields.prop_field), the samplers, camera rays and the
pointwise math, against the JAX package and the executed-reference golden.

Tolerances: weights and renders atol 1e-5; spaced sample bins atol 1e-6
(torch.linspace and jnp.linspace may differ by an ulp); inverse-CDF bins
atol 1e-5 (the CDF's cumsum is summed in another order, and the inverse
divides that difference by a bin's probability, down to ~1/40 here);
densities and encodings rtol 1e-5 with the atol stated at each check.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presight_tpu.data import cameras as JC
from presight_tpu.fields import prop_field as JPF
from presight_tpu.fields import router as JR
from presight_tpu.ops import math as JMath
from presight_tpu.ops import rays as JRays
from presight_tpu.ops import renderers as JRend
from presight_tpu.ops import samplers as JS
from presight_tpu_torch.configs import PropFieldConfig, SpacingSpec
from presight_tpu_torch.data import cameras as TC
from presight_tpu_torch.fields import prop_field as TPF
from presight_tpu_torch.ops import math as TMath
from presight_tpu_torch.ops import rays as TRays
from presight_tpu_torch.ops import renderers as TRend
from presight_tpu_torch.ops import samplers as TS

GOLD = Path(__file__).parent / "goldens"


def _t(a):
    return torch.from_numpy(np.array(a))


def _bundles(rng, n, near=0.005, far=50.0):
    o = (rng.randn(n, 3) * 0.5).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nears = np.full(n, near, np.float32)
    fars = np.full(n, far, np.float32)
    jb = JRays.RayBundle(origins=jnp.asarray(o), directions=jnp.asarray(d),
                         nears=jnp.asarray(nears), fars=jnp.asarray(fars))
    tb = TRays.RayBundle(origins=_t(o), directions=_t(d), nears=_t(nears), fars=_t(fars))
    return jb, tb


def _samples(rng, n, s):
    edges = np.sort(rng.rand(n, s + 1).astype(np.float32), axis=-1) * 20
    spacing = np.sort(rng.rand(n, s + 1).astype(np.float32), axis=-1)
    o = rng.randn(n, 3).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    kw = dict(starts=edges[:, :-1], ends=edges[:, 1:], spacing_starts=spacing[:, :-1],
              spacing_ends=spacing[:, 1:], origins=o, directions=d)
    return (JRays.RaySamples(**{k: jnp.asarray(v) for k, v in kw.items()}),
            TRays.RaySamples(**{k: _t(v) for k, v in kw.items()}))


def test_volume_render_plain_matches_jax_weights_and_depths():
    rng = np.random.RandomState(0)
    js, ts = _samples(rng, 128, 24)
    dens = (np.exp(rng.randn(128, 24) * 2) * 3).astype(np.float32)
    dens[0, 3] = np.inf  # an opaque sample
    dens[1, :] = 0.0  # an empty ray
    deltas = np.array(js.deltas())
    deltas[2, 5], dens[2, 5] = 0.0, np.inf  # 0 * inf: NaN weights flushed to 0
    w_ref = np.asarray(JRays.get_weights(jnp.asarray(deltas), jnp.asarray(dens)))
    out = TRend.volume_render(_t(deltas), _t(dens), ts.steps(), threshold=0.5)
    np.testing.assert_allclose(out["weights"].numpy(), w_ref, atol=1e-5)
    np.testing.assert_allclose(TRays.get_weights(_t(deltas), _t(dens)).numpy(), w_ref,
                               atol=1e-5)
    assert np.isfinite(out["weights"].numpy()).all()
    jw = jnp.asarray(w_ref)
    np.testing.assert_allclose(out["accumulation"].numpy(),
                               np.asarray(JRend.render_accumulation(jw)), atol=1e-5)
    np.testing.assert_allclose(out["depth"].numpy(),
                               np.asarray(JRend.render_depth_median(jw, js)), atol=1e-5)
    np.testing.assert_allclose(out["expected_depth"].numpy(),
                               np.asarray(JRend.render_depth_expected(jw, js)), atol=1e-5)
    for thr in (0.1, 0.9):
        np.testing.assert_allclose(TRend.render_depth_median(_t(w_ref), ts, thr).numpy(),
                                   np.asarray(JRend.render_depth_median(jw, js, thr)), atol=1e-5)


def test_volume_render_composite_matches_padded_segment_sum():
    """The composite through padded payload slots (payload_index = from_slot)
    equals JAX's segment_sum over padded slots (nerfacto_ms.forward)."""
    rng = np.random.RandomState(1)
    R, S, C, E = 40, 12, 7, 3
    deltas = (rng.rand(R, S) * 0.2).astype(np.float32)
    dens = (np.exp(rng.randn(R, S)) * 2).astype(np.float32)
    eids = rng.randint(0, E, R * S).astype(np.int32)
    routing = JR.build_padded_routing(jnp.asarray(eids), E, 16)
    n_pad = routing.to_slot.shape[0]
    payload = rng.rand(n_pad, C).astype(np.float32)
    w = JRays.get_weights(jnp.asarray(deltas), jnp.asarray(dens))
    w_slot = JR.pad_rows(w.reshape(-1), routing)
    ray_of_slot = routing.to_slot // S
    ref = jax.ops.segment_sum(jnp.asarray(payload) * w_slot[:, None], ray_of_slot,
                              num_segments=R)
    out = TRend.volume_render(_t(deltas), _t(dens), payload=_t(payload),
                              payload_index=_t(np.asarray(routing.from_slot)))
    np.testing.assert_allclose(out["composite"].numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("stratified", [False, True], ids=["midpoint", "jax-draws"])
def test_spaced_and_pdf_samples_match_jax(stratified):
    rng = np.random.RandomState(2)
    spec_j = JS.SpacingSpec("piecewise_threshold", threshold=5.0)
    spec_t = SpacingSpec("piecewise_threshold", threshold=5.0)
    jb, tb = _bundles(rng, 64)
    k1, k2 = jax.random.PRNGKey(3), jax.random.PRNGKey(4)
    u1 = _t(jax.random.uniform(k1, (64, 1))) if stratified else None
    js = JS.spaced_sample(k1, jb, 16, spec_j, stratified=stratified)
    ts = TS.spaced_sample(tb, 16, spec_t, u1)
    for name in ("starts", "ends", "spacing_starts", "spacing_ends"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    weights = (rng.rand(64, 16) ** 3).astype(np.float32)
    u2 = _t(jax.random.uniform(k2, (64, 1))) if stratified else None
    jp = JS.pdf_sample(k2, jb, js, jnp.asarray(weights), 8, spec_j, stratified=stratified,
                       eps=float(jnp.finfo(jnp.float32).eps))
    tp = TS.pdf_sample(tb, ts, _t(weights), 8, spec_t, u2,
                       eps=float(torch.finfo(torch.float32).eps))
    np.testing.assert_allclose(tp.spacing_starts.numpy(), np.asarray(jp.spacing_starts),
                               atol=1e-5)
    np.testing.assert_allclose(tp.spacing_ends.numpy(), np.asarray(jp.spacing_ends), atol=1e-5)
    np.testing.assert_allclose(tp.starts.numpy(), np.asarray(jp.starts), atol=1e-5, rtol=1e-4)


def test_proposal_sample_matches_jax():
    rng = np.random.RandomState(5)
    jb, tb = _bundles(rng, 48)
    spec_j = JS.SpacingSpec("piecewise_threshold", threshold=5.0)
    spec_t = SpacingSpec("piecewise_threshold", threshold=5.0)
    centre = np.array([0.3, -0.2, 0.1], np.float32)

    def jfn(p):
        return 20.0 * jnp.exp(-jnp.sum((p - centre) ** 2, axis=-1))

    def tfn(p):
        return 20.0 * torch.exp(-torch.sum((p - _t(centre)) ** 2, dim=-1))

    # jitted: one compile instead of one per operation
    js, jw, _ = jax.jit(lambda b: JS.proposal_sample(
        jax.random.PRNGKey(0), b, [jfn, jfn], (16, 12), 8, spec_j, jnp.asarray(1.0),
        stratified=False))(jb)
    ts, tw, _ = TS.proposal_sample(tb, [tfn, tfn], (16, 12), 8, spec_t)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(ts.spacing_starts.numpy(), np.asarray(js.spacing_starts),
                               atol=1e-5)
    np.testing.assert_allclose(ts.positions().numpy(), np.asarray(js.positions()),
                               atol=1e-5, rtol=1e-5)


def test_camera_rays_match_golden_and_jax():
    g = np.load(GOLD / "camera_rays.npz")
    C = g["c2w"].shape[0]
    kw = dict(c2w=g["c2w"], fx=np.full(C, float(g["fx"]), np.float32),
              fy=np.full(C, float(g["fy"]), np.float32), cx=np.full(C, float(g["cx"]), np.float32),
              cy=np.full(C, float(g["cy"]), np.float32), camera_type=g["ctype"],
              distortion_params=g["dist"])
    idx = np.stack([g["cam"], g["rows"], g["cols"]], -1).astype(np.int32)
    rb = TC.generate_rays(TC.CameraParams(**{k: _t(v) for k, v in kw.items()}), _t(idx))
    np.testing.assert_allclose(rb.origins.numpy(), g["origins"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rb.directions.numpy(), g["directions"], rtol=1e-4, atol=2e-5)
    jrb = JC.generate_rays(JC.CameraParams(**{k: jnp.asarray(v) for k, v in kw.items()}),
                           jnp.asarray(idx))
    np.testing.assert_allclose(rb.directions.numpy(), np.asarray(jrb.directions), atol=1e-6)
    # the plain perspective path (no types, no distortion), with video ids
    vid = np.arange(C, dtype=np.int32)
    plain = {k: kw[k] for k in ("c2w", "fx", "fy", "cx", "cy")}
    rb = TC.generate_rays(TC.CameraParams(**{k: _t(v) for k, v in plain.items()},
                                          video_ids=_t(vid)), _t(idx))
    jrb = JC.generate_rays(JC.CameraParams(**{k: jnp.asarray(v) for k, v in plain.items()},
                                           video_ids=jnp.asarray(vid)), jnp.asarray(idx))
    np.testing.assert_allclose(rb.directions.numpy(), np.asarray(jrb.directions), atol=1e-6)
    np.testing.assert_array_equal(rb.video_ids.numpy(), np.asarray(jrb.video_ids))
    np.testing.assert_array_equal(rb.camera_indices.numpy(), np.asarray(jrb.camera_indices))


def test_contract_positions_and_sh_match_jax():
    rng = np.random.RandomState(6)
    pos = (rng.randn(500, 3) * 4).astype(np.float32)
    aabb = np.stack([np.full((500, 3), -2.0), np.full((500, 3), 3.0)], 1).astype(np.float32)
    unit, sel = TMath.contract_positions(_t(pos), _t(aabb))
    junit, jsel = JMath.contract_positions(jnp.asarray(pos), jnp.asarray(aabb))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_allclose(unit.numpy(), np.asarray(junit), rtol=1e-6, atol=1e-7)
    d = pos / np.linalg.norm(pos, axis=-1, keepdims=True)
    np.testing.assert_allclose(TMath.sh_encoding(_t(d)).numpy(),
                               np.asarray(JMath.sh_encoding(jnp.asarray(d))), atol=1e-6)


def test_prop_field_and_cached_grid_match_jax():
    """prop_density (shared MLP), refresh_prop_grid / prop_grid_cells and
    K4's plain version prop_grid_density, on identical weights."""
    jcfg = JPF.PropFieldConfig(num_levels=2, base_res=4, max_res=32, log2_hashmap_size=7,
                               features_per_level=2, hash_storage="shared", shared_mlp=True)
    tcfg = PropFieldConfig(num_levels=2, base_res=4, max_res=32, log2_hashmap_size=7,
                           features_per_level=2, hash_storage="shared", shared_mlp=True)
    rng = np.random.RandomState(7)
    cent = (rng.randn(3, 3) * 2).astype(np.float32)
    aabbs = np.stack([np.stack([c - 2.5, c + 2.5]) for c in cent]).astype(np.float32)
    # jitted: one compile instead of one per operation
    jp = jax.jit(lambda k: JPF.init_prop_field(k, jcfg, 3, jnp.asarray(aabbs),
                                               jnp.asarray(cent)))(jax.random.PRNGKey(0))
    # Larger table values than the init's 1e-4 give densities far from 1.
    jp["hash_table"] = [t * 2e4 for t in jp["hash_table"]]
    tp = jax.tree_util.tree_map(lambda a: _t(a), jp)
    pos = np.concatenate([(rng.randn(400, 3) * 4), cent, aabbs[:, 1]]).astype(np.float32)
    np.testing.assert_allclose(
        TPF.prop_density(tp, tcfg, _t(pos)).numpy(),
        np.asarray(jax.jit(lambda p, x: JPF.prop_density(p, jcfg, x))(jp, jnp.asarray(pos))),
        rtol=1e-5, atol=1e-6)
    jgrid = jax.jit(lambda p: JPF.refresh_prop_grid(p, jcfg, 6, 3))(jp)
    tgrid = TPF.refresh_prop_grid(tp, tcfg, 6, 3)
    assert tuple(tgrid.shape) == (3 * 6 ** 3, 8)
    np.testing.assert_allclose(tgrid.numpy(), np.asarray(jgrid), rtol=1e-5, atol=1e-6)
    dens = TPF.prop_grid_density(tgrid, _t(cent), _t(aabbs), _t(pos), 6)
    ref = jax.jit(lambda g, c, a, x: JPF.prop_grid_density(g, c, a, x, 6))(
        jgrid, jnp.asarray(cent), jnp.asarray(aabbs), jnp.asarray(pos))
    np.testing.assert_allclose(dens.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    corners = rng.rand(2, 5, 5, 5).astype(np.float32)
    np.testing.assert_array_equal(TPF.prop_grid_cells(_t(corners)).numpy(),
                                  np.asarray(JPF.prop_grid_cells(jnp.asarray(corners))))
