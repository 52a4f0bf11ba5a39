"""One-way importer: reference PreSight checkpoints -> the port's parameter
tree (presight_tpu/engine/import_reference.py).

The reference saves ``step-%09d.ckpt`` files holding ``{"step", "pipeline":
pipeline.state_dict(), ...}`` (nerfstudio-0.3.3/nerfstudio/engine/
trainer.py:432-460). The pipeline state_dict prefixes the model as
``_model.`` (``module.`` first under DDP), with module names from
nerfacto_nusc_ms.py:213-385:

  _model.field.fields.{e}.mlp_base_grid.hash_table        (L*T, F)
  _model.field.fields.{e}.mlp_base_mlp.layers.{i}.weight  (out, in) torch
  _model.field.fields.{e}.rgb_head.layers.{i}.weight
  _model.field.fields.{e}.semantic_head.layers.{i}.weight
  _model.field.fields.{e}.aabb                            (2, 3) buffer
  _model.field.centroids                                  (E, 3) buffer
  _model.proposal_networks.{p}.fields.{e}.encoding.hash_table
  _model.proposal_networks.{p}.fields.{e}.mlp_base.1.layers.{i}.weight
  _model.sky_model.fields.{e}.{rgb,semantic}_head.layers.{i}.weight
  _model.appearance_embedding.embedding.weight
  _model.video_embedding.embedding.weight

They map onto the tree ``init_model`` builds: per-expert tensors stack on a
leading E axis, torch Linear (out, in) weights transpose to (in, out), and
the per-expert (L*T, F) hash tables concatenate into the flat (E*L*T, F)
'corner' table (ops/hash_encoding.py ``init_hash_table``). Only the
reference-exact architecture accepts an import: 'corner' storage and no
cached grid ('cell' and 'shared' tables and the grid have no weight-space
mapping). The tree is assembled in numpy and handed to ``bridge``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..bridge import from_jax_params
from ..configs import NerfactoNuscMSConfig


def strip_prefixes(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Drop the pipeline's ``_model.`` and DDP's ``module.`` prefixes."""
    return {re.sub(r"^(module\.)?(_model\.)?", "", k): np.asarray(v) for k, v in state.items()}


def _num_experts(state: Dict[str, np.ndarray], prefix: str) -> int:
    pat = re.compile(re.escape(prefix) + r"fields\.(\d+)\.")
    experts = {int(m.group(1)) for m in map(pat.match, state) if m}
    if not experts:
        raise ValueError(f"no experts found under {prefix!r}")
    return max(experts) + 1


def _mlp_layers(state: Dict[str, np.ndarray], template: str,
                num_experts: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-expert torch MLP layers ({e} the expert, {i} the layer) ->
    [(W (E, in, out), b (E, out)), ...]."""
    layers = []
    i = 0
    while template.format(e=0, i=i) + ".weight" in state:
        names = [template.format(e=e, i=i) for e in range(num_experts)]
        layers.append((np.stack([state[n + ".weight"].T for n in names]),
                       np.stack([state[n + ".bias"] for n in names])))
        i += 1
    if not layers:
        raise ValueError(f"no MLP layers matched {template!r}")
    return layers


def _hash_table(state: Dict[str, np.ndarray], template: str, num_experts: int) -> np.ndarray:
    """Per-expert (L*T, F) tables -> the flat 'corner' table (E*L*T, F)."""
    return np.concatenate([state[template.format(e=e)] for e in range(num_experts)], axis=0)


def import_reference_state_dict(state: Dict[str, np.ndarray], config: NerfactoNuscMSConfig,
                                device=None) -> Dict:
    """Reference pipeline state_dict -> the port's parameter tree on
    ``device`` (the CUDA card unless the caller asks for another). ``config``
    must have 'corner' storage and no cached grid; raises on layouts that
    do not match."""
    if config.hash_storage != "corner":
        raise ValueError("reference checkpoints import only into the reference-exact 'corner' "
                         f"hash storage (config has {config.hash_storage!r})")
    if config.use_prop_grid:
        raise ValueError("reference checkpoints have no cached-grid round; set prop_grid_res=0")
    state = strip_prefixes(state)
    num_experts = _num_experts(state, "field.")
    aabbs = np.stack([state[f"field.fields.{e}.aabb"] for e in range(num_experts)])
    centroids = state["field.centroids"]

    # Key order as init_params builds the tree.
    field = {
        "hash_table": _hash_table(state, "field.fields.{e}.mlp_base_grid.hash_table",
                                  num_experts),
        "base_mlp": _mlp_layers(state, "field.fields.{e}.mlp_base_mlp.layers.{i}", num_experts),
        "rgb_head": _mlp_layers(state, "field.fields.{e}.rgb_head.layers.{i}", num_experts),
        "aabbs": aabbs,
        "centroids": centroids,
    }
    if config.use_semantics:
        field["semantic_head"] = _mlp_layers(state, "field.fields.{e}.semantic_head.layers.{i}",
                                             num_experts)
    props = []
    while f"proposal_networks.{len(props)}.fields.0.encoding.hash_table" in state:
        p = len(props)
        props.append({
            "hash_table": _hash_table(
                state, f"proposal_networks.{p}.fields.{{e}}.encoding.hash_table", num_experts),
            "mlp": _mlp_layers(state, f"proposal_networks.{p}.fields.{{e}}.mlp_base.1.layers.{{i}}",
                               num_experts),
            "aabbs": aabbs,
            "centroids": centroids,
        })
    if not props:
        raise ValueError("no proposal networks found in the checkpoint")
    params: Dict = {"field": field, "props": props}
    if config.use_sky_model and "sky_model.fields.0.rgb_head.layers.0.weight" in state:
        sky = {"rgb_head": _mlp_layers(state, "sky_model.fields.{e}.rgb_head.layers.{i}",
                                       num_experts),
               "centroids": centroids}
        if config.use_semantics:
            sky["semantic_head"] = _mlp_layers(
                state, "sky_model.fields.{e}.semantic_head.layers.{i}", num_experts)
        params["sky"] = sky
    for key in ("appearance_embedding", "video_embedding"):
        if f"{key}.embedding.weight" in state:
            params[key] = state[f"{key}.embedding.weight"]
    return from_jax_params(params, device=torch.device(device if device is not None else "cuda"))


def load_reference_checkpoint(path: Path, config: NerfactoNuscMSConfig,
                              device=None) -> Tuple[Dict, Optional[int]]:
    """Load a reference ``step-*.ckpt`` (a torch pickle with the pipeline's
    state under 'pipeline') and import it. Returns (params, step or None)."""
    raw = torch.load(str(path), map_location="cpu", weights_only=False)
    state = raw["pipeline"] if "pipeline" in raw else raw
    state = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
             for k, v in state.items()}
    step = raw.get("step")
    return (import_reference_state_dict(state, config, device),
            int(step) if step is not None else None)
