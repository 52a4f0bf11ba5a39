"""The port's method registry and config.yml reader and writer
(presight_tpu_torch/configs/) against the JAX package's, with PyYAML as the
oracle for the bytes: for every named method the port writes exactly what
``yaml.safe_dump(to_dict(config), sort_keys=False)`` writes, reads the
JAX-written file back to its own registry's config, and the JAX package
loads the port's file back to its own. Overrides coerce as the JAX
functions do.
"""

import copy
import dataclasses
from pathlib import Path

import pytest
import yaml

from presight_tpu.configs import config_io as JIO
from presight_tpu.configs.method_configs import method_configs as JAX_METHODS
from presight_tpu_torch.configs import config_io as TIO
from presight_tpu_torch.configs.method_configs import method_configs as PORT_METHODS

NAMES = list(JAX_METHODS)


def test_registry_has_the_jax_names_in_order():
    assert len(NAMES) == 73 and list(PORT_METHODS) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_config_yml_bytes_and_both_loaders(name, tmp_path):
    ref = yaml.safe_dump(JIO.to_dict(JAX_METHODS[name]), sort_keys=False)
    port = PORT_METHODS[name]
    assert TIO.dumps(TIO.to_dict(port)) == ref
    (tmp_path / "jax.yml").write_text(ref)
    assert TIO.load_config(tmp_path / "jax.yml") == port
    TIO.save_config(port, tmp_path / "port.yml")
    assert JIO.load_config(tmp_path / "port.yml") == JAX_METHODS[name]


@pytest.mark.parametrize("value", [
    "", "0", "1e5", "1.5", ".5", "0x1f", "1:30", "~", "null", "on", "No", "#x", "a #b", "a:b",
    "x:", "a: b", "@a", "2020-01-01", "- a", "-x", "a b", " lead", "trail ", ".nan", "=", "<<",
    "!x", "it's", "[a]", "{a}", "a,b", "?x", "? x", "---", "2024-01-01_120000",
    1e-15, 1e17, 0.1, -0.0, float("inf"), 3, -3, True, None, [], {}, [[1, 2], [3]],
    [{"a": []}], {"a": {}}])
def test_yaml_scalars_and_nesting_match_pyyaml(value):
    # Copies: PyYAML writes an object met twice as an anchor and alias,
    # which config trees never hold.
    data = {"k": copy.deepcopy(value), "n": {"list": [copy.deepcopy(value), copy.deepcopy(value)]}}
    text = yaml.safe_dump(data, sort_keys=False)
    assert TIO.dumps(data) == text
    assert TIO.loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("overrides", [
    {"max-num-iterations": "7", "pipeline.model.num_levels": "3"},
    {"pipeline.model.use_semantics": "false", "pipeline.datamanager.group-balanced": "0"},
    {"pipeline.model.num_proposal_samples_per_ray": "32,16",
     "pipeline.dataparser.cameras": "CAM_FRONT CAM_BACK"},
    {"output-dir": "/tmp/runs", "pipeline.dataparser.centroids_dir": "some/dir",
     "load-dir": "runs/x"},
    {"pipeline.dataparser.scene_names": "scene-0001,scene-0002",
     "optimizers.fields.lr": "0.003", "optimizers.proposal_networks.milestones": "1 2 3"},
    {"timestamp": "t0", "pipeline.model.pulse_width": "0.1,0.01", "zero1": "no"},
], ids=["int", "bool", "tuple", "path", "optional", "mixed"])
def test_apply_overrides_matches_jax(overrides):
    for name in ("synthetic-demo", "boston-seaport-camera-dino-c0-tpu"):
        ref = JIO.apply_overrides(JAX_METHODS[name], overrides)
        got = TIO.apply_overrides(PORT_METHODS[name], overrides)
        assert TIO.to_dict(got) == JIO.to_dict(ref)
    with pytest.raises(KeyError):
        TIO.apply_overrides(PORT_METHODS["synthetic-demo"], {"pipeline.no_such_field": "1"})


def test_parse_cli_overrides_matches_jax():
    argv = ["--a.b", "1", "--c-d=2", "--e.f.g", "x y", "--h", "--"]
    assert TIO.parse_cli_overrides(argv) == JIO.parse_cli_overrides(argv)
    for bad in (["a"], ["--a"]):
        with pytest.raises(ValueError):
            TIO.parse_cli_overrides(bad)


def test_paths_and_tuples_round_trip(tmp_path):
    cfg = dataclasses.replace(
        PORT_METHODS["synthetic-demo"], output_dir=Path("/tmp/x y"), load_dir=Path("0123"),
        pipeline=dataclasses.replace(
            PORT_METHODS["synthetic-demo"].pipeline,
            dataparser=dataclasses.replace(PORT_METHODS["synthetic-demo"].pipeline.dataparser,
                                           scene_names=("a", "b"))))
    TIO.save_config(cfg, tmp_path / "c.yml")
    back = TIO.load_config(tmp_path / "c.yml")
    assert back == cfg and isinstance(back.pipeline.dataparser.scene_names, tuple)
