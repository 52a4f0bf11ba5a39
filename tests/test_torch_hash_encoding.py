"""K1's module, presight_tpu_torch.ops.hash_encoding, against the JAX
package (presight_tpu.ops.hash_encoding) and the executed-reference golden.

Tolerances: hash indices exact; encodings rtol 1e-5, atol 1e-7 (f32 sums of
8 corner products taken in another order).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presight_tpu.ops import hash_encoding as JH
from presight_tpu_torch.configs import HashEncodingConfig
from presight_tpu_torch.ops import hash_encoding as TH

GOLD = Path(__file__).parent / "goldens"


def _configs(storage):
    kw = dict(num_levels=3, min_res=4, max_res=64, log2_hashmap_size=8,
              features_per_level=2, storage=storage)
    return JH.HashEncodingConfig(**kw), HashEncodingConfig(**kw)


def _positions(rng, n, scalings):
    """Random points plus points exactly on grid nodes of every level (where
    ceil == floor) and on the cube's faces."""
    pos = rng.rand(n, 3).astype(np.float32)
    nodes = [rng.randint(0, int(s) + 1, (8, 3)).astype(np.float32) / s for s in scalings]
    faces = np.array([[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 0.25]], np.float32)
    return np.concatenate([pos, *nodes, faces]).astype(np.float32)


@pytest.mark.parametrize("with_experts", [False, True], ids=["single", "experts"])
@pytest.mark.parametrize("storage", ["corner", "cell", "shared"])
def test_hash_encode_matches_jax(storage, with_experts):
    jcfg, tcfg = _configs(storage)
    rng = np.random.RandomState(1)
    num_experts = 3 if with_experts else 1
    table = JH.init_hash_table(jax.random.PRNGKey(0), jcfg, num_experts)
    # Scale the tables up so the tolerance is not all atol.
    table_np = jax.tree_util.tree_map(lambda t: np.asarray(t) * 1e4, table)
    pos = _positions(rng, 300, tcfg.scalings())
    eids = rng.randint(0, num_experts, len(pos)).astype(np.int32) if with_experts else None

    ref = JH.hash_encode(jax.tree_util.tree_map(jnp.asarray, table_np), jnp.asarray(pos), jcfg,
                         None if eids is None else jnp.asarray(eids))
    t_table = ([torch.from_numpy(t) for t in table_np] if storage == "shared"
               else torch.from_numpy(table_np))
    out = TH.hash_encode(t_table, torch.from_numpy(pos), tcfg,
                         None if eids is None else torch.from_numpy(eids))
    assert out.shape == (len(pos), tcfg.out_dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7)


def test_hash_indices_exact():
    """The int64 masked hash equals JAX's uint32 wraparound bit for bit, and
    so does the 'shared' expert mix, over the full coordinate range."""
    rng = np.random.RandomState(2)
    coords = np.concatenate([
        rng.randint(0, 1 << 20, (2000, 3)),
        np.array([[0, 0, 0], [16384, 16384, 16384], [(1 << 31) - 1] * 3, [1, 2, 3]]),
    ]).astype(np.int32)
    ref = np.asarray(JH._raw_hash(jnp.asarray(coords))).astype(np.int64)
    np.testing.assert_array_equal(TH._raw_hash(torch.from_numpy(coords)).numpy(), ref)
    for t in (1 << 8, 1 << 17):
        np.testing.assert_array_equal(
            TH._hash_corners(torch.from_numpy(coords), t).numpy(),
            np.asarray(JH._hash_corners(jnp.asarray(coords), t)))
    eids = rng.randint(0, 16, 2000).astype(np.int32)
    ref_mix = np.asarray(jnp.asarray(eids).astype(jnp.uint32)
                         * jnp.uint32(JH._EXPERT_PRIME)).astype(np.int64)
    port_mix = (torch.from_numpy(eids).long() * TH._EXPERT_PRIME) & TH._U32
    np.testing.assert_array_equal(port_mix.numpy(), ref_mix)


def test_scalings_and_trilerp_weights_match_jax():
    for kw in (dict(num_levels=10, min_res=16, max_res=16384),
               dict(num_levels=4, min_res=16, max_res=16384),
               dict(num_levels=2, min_res=16, max_res=4096)):
        np.testing.assert_array_equal(HashEncodingConfig(**kw).scalings(),
                                      JH.HashEncodingConfig(**kw).scalings())
    off = np.random.RandomState(3).rand(64, 3).astype(np.float32)
    np.testing.assert_allclose(TH.trilerp_weights(torch.from_numpy(off)).numpy(),
                               np.asarray(JH.trilerp_weights(jnp.asarray(off))),
                               rtol=1e-6, atol=0)


def test_hash_encode_matches_executed_reference_golden():
    g = np.load(GOLD / "hash_encoding.npz")
    L, min_res, max_res, log2, F = (int(v) for v in g["config"])
    cfg = HashEncodingConfig(num_levels=L, min_res=min_res, max_res=max_res,
                             log2_hashmap_size=log2, features_per_level=F, storage="corner")
    out = TH.hash_encode(torch.from_numpy(g["table"]), torch.from_numpy(g["positions"]), cfg)
    np.testing.assert_allclose(out.numpy(), g["output"], rtol=1e-5, atol=1e-6)
