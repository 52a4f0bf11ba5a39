"""The reference architecture in the port: a hash-field first proposal
round, per-expert proposal MLPs and 'corner' hash storage (the JAX
package's defaults), and the importer of reference checkpoints.

  * The executed reference golden (tests/goldens/full_model.npz) through
    the port's importer: the eval forward under test_full_model_parity.py's
    quantile checks and tolerances, the field queries at its rtol and atol.
  * The importer's tree against init_model's, its refusals, and a
    reference ``.ckpt`` written by torch.save from the golden's state_dict.
  * The tiny slice config of test_torch_slice.py made reference-exact
    ('corner', per-expert proposal MLPs, no cached grid) against the JAX
    package on the same weights (drawn by the port, carried by the bridge):
    forward in eval and train mode (with JAX's draws), forward_depth,
    point_queries and ImageRenderer.render at atol 1e-5 + rtol 1e-5 (the
    slice tests' tolerance); forward also with 'cell' storage and with one
    proposal network shared across rounds; the cached grid refreshed from
    per-expert proposal MLPs.
The training step at this config is held against JAX in
test_torch_train.py (``test_train_step_matches_jax[reference]``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presight_tpu.data import cameras as JC
from presight_tpu.engine import evaluator as JE
from presight_tpu.models import nerfacto_ms as JM
from presight_tpu.ops.rays import RayBundle as JRayBundle
from presight_tpu_torch import bridge, configs as TCfg
from presight_tpu_torch.data import cameras as TC
from presight_tpu_torch.engine.evaluator import ImageRenderer
from presight_tpu_torch.engine.import_reference import (
    import_reference_state_dict,
    load_reference_checkpoint,
)
from presight_tpu_torch.fields.prop_field import prop_density
from presight_tpu_torch.models import nerfacto_ms as TM
from presight_tpu_torch.ops.rays import RayBundle
from test_torch_cuda import check_golden_forward, check_golden_queries, golden_bundle, load_golden
from test_torch_slice import TINY
from test_torch_train import _jax_draws

REFERENCE = dict(TINY, hash_storage="corner", prop_shared_mlp=False, prop_grid_res=0)
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# The executed reference golden
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    return load_golden()


def test_golden_eval_forward(golden):
    state, io, cfg = golden
    model = TM.NerfactoNuscMS(cfg, import_reference_state_dict(state, cfg, device="cpu"))
    out = model(golden_bundle(io, "cpu"), train=False, stop_prop_grad=True)
    check_golden_forward({k: v.numpy() for k, v in out.items() if torch.is_tensor(v)}, io)


def test_golden_field_queries(golden):
    state, io, cfg = golden
    model = TM.NerfactoNuscMS(cfg, import_reference_state_dict(state, cfg, device="cpu"))
    check_golden_queries(model, io)


def test_importer_tree_matches_init_model(golden):
    state, _, cfg = golden
    params = import_reference_state_dict(state, cfg, device="cpu")
    init = TM.init_model(torch.Generator().manual_seed(0), cfg, params["field"]["aabbs"],
                         params["field"]["centroids"], 8, 2, device="cpu").params()
    shapes = lambda tree: bridge._map(tree, lambda t: (tuple(t.shape), t.dtype))  # noqa: E731
    assert shapes(params) == shapes(init)
    leaves = []
    bridge._map(params, leaves.append)
    assert all(t.is_contiguous() for t in leaves)  # as the kernels take them
    assert [list(sub) for sub in params.values() if isinstance(sub, dict)] == \
        [list(sub) for sub in init.values() if isinstance(sub, dict)]
    # Per-expert tensors stacked on E, Linear weights transposed to (in, out),
    # the experts' (L*T, F) tables concatenated into the flat 'corner' table.
    w = state["field.fields.1.mlp_base_mlp.layers.0.weight"]
    np.testing.assert_array_equal(params["field"]["base_mlp"][0][0][1].numpy(), w.T)
    table = state["proposal_networks.1.fields.1.encoding.hash_table"]
    np.testing.assert_array_equal(params["props"][1]["hash_table"][len(table):].numpy(), table)


@pytest.mark.parametrize("change,match", [(dict(hash_storage="shared"), "corner"),
                                          (dict(prop_grid_res=8), "cached-grid")],
                         ids=["shared_storage", "cached_grid"])
def test_importer_refuses_tpu_layouts(golden, change, match):
    state, _, cfg = golden
    with pytest.raises(ValueError, match=match):
        import_reference_state_dict(state, dataclasses.replace(cfg, **change), device="cpu")


def test_load_reference_checkpoint(golden, tmp_path):
    """A reference step-*.ckpt: the pipeline's state_dict under 'pipeline'
    with the model's '_model.' prefix (and DDP's 'module.'), and the step."""
    state, io, cfg = golden
    path = tmp_path / "step-000001234.ckpt"
    torch.save({"step": 1234, "pipeline": {f"module._model.{k}": torch.from_numpy(v)
                                           for k, v in state.items()},
                "optimizers": {}}, path)
    params, step = load_reference_checkpoint(path, cfg, device="cpu")
    assert step == 1234
    want = import_reference_state_dict(state, cfg, device="cpu")
    got_leaves, want_leaves = [], []
    bridge._map(params, got_leaves.append)
    bridge._map(want, want_leaves.append)
    assert len(got_leaves) == len(want_leaves) > 0
    for a, b in zip(got_leaves, want_leaves):
        assert torch.equal(a, b)
    out = TM.NerfactoNuscMS(cfg, params)(golden_bundle(io, "cpu"), train=False,
                                         stop_prop_grad=True)
    check_golden_forward({k: v.numpy() for k, v in out.items() if torch.is_tensor(v)}, io)


# ---------------------------------------------------------------------------
# The tiny reference-exact config against the JAX package
# ---------------------------------------------------------------------------


def _scaled_tables(params_np):
    """Table values well above the 1e-4 init, so densities and colours vary."""
    for tree in [params_np["field"], *params_np["props"]]:
        t = tree["hash_table"]
        tree["hash_table"] = [x * 3e3 for x in t] if isinstance(t, list) else t * 3e3
    return params_np


def _models(kw, aabbs, cent, num_cameras=6, num_videos=2):
    jcfg, tcfg = JM.NerfactoNuscMSConfig(**kw), TCfg.NerfactoNuscMSConfig(**kw)
    init = TM.init_model(torch.Generator().manual_seed(0), tcfg, aabbs, cent, num_cameras,
                         num_videos, device="cpu")
    params_np = _scaled_tables(bridge.to_numpy(init.params()))
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, params_np),
            TM.NerfactoNuscMS(tcfg, bridge.from_jax_params(params_np)))


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(0)
    cent = (rng.randn(2, 3) * 0.5).astype(np.float32)
    aabbs = np.stack([np.stack([c - 1.5, c + 1.5]) for c in cent]).astype(np.float32)
    R = 96
    o = (rng.randn(R, 3) * 0.3).astype(np.float32)
    d = rng.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    kw = dict(origins=o, directions=d, nears=np.zeros(R, np.float32),
              fars=np.ones(R, np.float32), camera_indices=rng.randint(0, 6, R).astype(np.int32),
              video_ids=rng.randint(0, 2, R).astype(np.int32))
    jb = JRayBundle(**{k: jnp.asarray(v) for k, v in kw.items()})
    tb = RayBundle(**{k: _t(v) for k, v in kw.items()})
    pts = (rng.randn(200, 3) * 1.2).astype(np.float32)
    return aabbs, cent, jb, tb, pts, rng


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=ATOL)


def _close_forward(to, jo, rounds):
    for key in ("rgb", "accumulation", "depth", "expected_depth", "semantics"):
        _close(to[key].detach().numpy(), jo[key])
    assert len(to["weights_list"]) == len(jo["weights_list"]) == rounds
    for a, b in zip(to["weights_list"], jo["weights_list"]):
        _close(a.detach().numpy(), b)
    for a, b in zip(to["ray_samples_list"], jo["ray_samples_list"]):
        _close(a.starts.numpy(), b.starts)


@pytest.fixture(scope="module")
def reference_run(scene):
    aabbs, cent, jb, tb, pts, rng = scene
    jcfg, params, model = _models(REFERENCE, aabbs, cent)
    c2w = np.tile(np.eye(3, 4, dtype=np.float32)[None], (2, 1, 1))
    c2w[:, :3, 3] = (rng.randn(2, 3) * 0.3).astype(np.float32)
    cams = dict(c2w=c2w, fx=np.full(2, 8.0, np.float32), fy=np.full(2, 8.0, np.float32),
                cx=np.full(2, 10.0, np.float32), cy=np.full(2, 3.0, np.float32),
                video_ids=np.array([0, 1], np.int32))
    key = jax.random.PRNGKey(3)
    rounds = len(jcfg.num_proposal_samples_per_ray) + 1
    ref = {
        "eval": jax.jit(lambda p, b: JM.forward(p, jcfg, b, key, 1.0, train=False,
                                                stop_prop_grad=True))(params, jb),
        "train": jax.jit(lambda p, b: JM.forward(p, jcfg, b, key, 0.7, train=True))(params, jb),
        "depth": jax.jit(lambda p, b: JM.forward_depth(p, jcfg, b, key))(params, jb),
        "points": jax.jit(lambda p, x: JM.point_queries(p, jcfg, x))(params, jnp.asarray(pts)),
        "image": JE.ImageRenderer(jcfg, chunk=64).render(
            params, JC.CameraParams(**{k: jnp.asarray(v) for k, v in cams.items()}), 1, 6, 20),
    }
    out = {
        "eval": model(tb, train=False, stop_prop_grad=True),
        "train": model(tb, train=True, anneal=0.7,
                       uniforms=_jax_draws(key, 1, tb.num_rays, rounds)[0]),
        "depth": model.forward_depth(tb),
        "points": model.point_queries(_t(pts)),
        "image": ImageRenderer(model.config, chunk=64).render(
            model, TC.CameraParams(**{k: _t(v) for k, v in cams.items()}), 1, 6, 20),
    }
    return ref, out, model


def test_reference_tree_has_per_expert_proposal_fields(reference_run):
    _, _, model = reference_run
    params = model.params()
    assert model.make_prop_grid() is None
    assert len(params["props"]) == 2  # rounds 0 and 1, no grid
    for prop in params["props"]:
        assert prop["hash_table"].dim() == 2  # one flat 'corner' table
        assert tuple(prop["mlp"][0][0].shape) == (2, 4, 64)  # (E, in, out)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_reference_forward_matches_jax(reference_run, mode):
    ref, out, _ = reference_run
    _close_forward(out[mode], ref[mode], rounds=3)
    acc = out[mode]["accumulation"].detach().numpy()
    assert 0.0 < acc.mean() < 1.0  # neither empty nor saturated everywhere


def test_reference_forward_depth_matches_jax(reference_run):
    ref, out, _ = reference_run
    for key in ("depth", "expected_depth"):
        _close(out["depth"][key].numpy(), ref["depth"][key])


def test_reference_point_queries_match_jax(reference_run):
    ref, out, _ = reference_run
    (jd, jf), (td, tf) = ref["points"], out["points"]
    _close(td.numpy(), jd)
    _close(tf.numpy(), jf)


def test_reference_image_render_matches_jax(reference_run):
    ref, out, _ = reference_run
    assert set(out["image"]) == set(ref["image"])
    for key, v in ref["image"].items():
        assert out["image"][key].shape == v.shape
        _close(out["image"][key], v)


@pytest.mark.parametrize("change", [dict(hash_storage="cell"),
                                    dict(use_same_proposal_network=True)],
                         ids=["cell_storage", "same_proposal_network"])
def test_reference_variant_forward_matches_jax(scene, change):
    """Without the cached grid: 'cell' storage, and one proposal network
    evaluated in both rounds (props[0] with round 0's config)."""
    aabbs, cent, jb, tb, _, _ = scene
    jcfg, params, model = _models(dict(REFERENCE, **change), aabbs, cent)
    key = jax.random.PRNGKey(0)
    jo = jax.jit(lambda p, b: JM.forward(p, jcfg, b, key, 1.0, train=False,
                                         stop_prop_grad=True))(params, jb)
    assert len(model.params()["props"]) == len(params["props"])
    _close_forward(model(tb, train=False, stop_prop_grad=True), jo, rounds=3)


def test_prop_grid_from_per_expert_mlps_matches_jax(scene):
    """The cached grid refreshed from per-expert proposal MLPs, and the
    forward that reads it."""
    aabbs, cent, jb, tb, _, _ = scene
    jcfg, params, model = _models(dict(REFERENCE, prop_grid_res=8), aabbs, cent)
    jgrid = jax.jit(lambda p: JM.make_prop_grid(p, jcfg))(params)
    tgrid = model.make_prop_grid()
    assert tgrid.shape == (2 * 8 ** 3, 8)
    _close(tgrid.numpy(), jgrid)
    key = jax.random.PRNGKey(0)
    jo = jax.jit(lambda p, b, g: JM.forward(p, jcfg, b, key, 1.0, train=False,
                                            stop_prop_grad=True, prop_grid=g))(params, jb, jgrid)
    _close_forward(model(tb, prop_grid=tgrid), jo, rounds=2)
