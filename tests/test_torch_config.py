"""The port's config layer (floodseg_tpu_torch/core/config.py and its YAML
reader, core/yaml_subset.py) against the JAX package's
(floodseg_tpu/core/config.py, PyYAML), on the CPU.

Every layering of configs/ resolves to the same Config field by field
(values and types), ``fit_config`` maps each field ``FIELDS`` names onto
FitConfig, overrides coerce as the JAX package coerces them (its quirks
included), the YAML reader gives ``yaml.safe_load``'s values, and every
config field is either read or raises when set.
"""

import dataclasses
import os

import pytest
import yaml

from floodseg_tpu.core import config as jax_config

from floodseg_tpu_torch.core import config, yaml_subset
from floodseg_tpu_torch.core.config import (
    FIELDS,
    NOT_READ,
    default_fit_config,
    fit_config,
    get_dotted,
)
from floodseg_tpu_torch.train import FitConfig

import test_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
METHODS = ("supervised", "flow_supervised", "gan", "flow_gan", "contrastive")
ARCHS = ("pspnet", "deeplabv3", "vit")
DATASETS = {"flow": ["dataset_flow.yaml"],
            "only_water": ["dataset_flow.yaml", "dataset_flow_only_water.yaml"]}


def _files(method, arch, dataset):
    names = ["train_base.yaml", f"train_{method}.yaml"] + DATASETS[dataset] + [f"{arch}.yaml"]
    return [os.path.join(CONFIGS, n) for n in names]


def _same(a, b, path=""):
    """Equal values of equal types, recursively (1 == 1.0 is not enough)."""
    assert type(a) is type(b), (path, a, b)
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def _expected_fit_value(cfg, path: str, name: str):
    """What ``fit_config`` puts in FitConfig.``name`` from ``path``."""
    value = get_dotted(cfg, path)
    if name == "optimizer":
        return value.lower()
    if name == "aux_weight":
        return cfg.model.aux_weight if cfg.model.aux else 0.0
    if name in ("classes_ignore", "test_scales"):
        return tuple(value)
    return value


def _check_fit_mapping(cfg):
    fc = fit_config(cfg)
    for path, reader in FIELDS.items():
        if not reader.startswith("fit:"):
            continue
        name = reader[len("fit:"):]
        got = get_dotted(fc, name)
        _same(got, _expected_fit_value(cfg, path, name.split(".")[-1]), path)
    return fc


@pytest.mark.parametrize("dataset", sorted(DATASETS))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("method", METHODS)
def test_layered_configs_match_jax(method, arch, dataset):
    """The port's resolved Config equals the JAX package's load_config field
    by field, and fit_config carries each field FIELDS maps to FitConfig."""
    files = _files(method, arch, dataset)
    ours, ref = config.load_config(files), jax_config.load_config(files)
    _same(config.config_to_dict(ours), jax_config.config_to_dict(ref))
    assert ours.method == method and ours.model.arch == arch
    fc = _check_fit_mapping(ours)
    assert fit_config(ref) == fc  # the mapping reads the JAX Config the same way


@pytest.mark.parametrize("argv", [
    ["--model.arch", "vit", "--data.train_w", "100", "--trainer.limit_val_batches", "2",
     "--model.int8_decode", "true", "--data.data_variant", "~", "--model.optim.lr", "1e-4",
     "--model.test_scales", "[1.0, 1.25]", "--trainer.run_name", "yes"],
    ["--model.arch=deeplabv3", "--data.train_w=433", "--trainer.limit_test_batches=0",
     "--model.int8_decode=off", "--trainer.num_devices=1", "--model.optim.lr=1.0e-4",
     "--data.data_classes_ignore=[2, 3]", "--model.power=1", "--method=gan"],
], ids=["space", "equals"])
def test_overrides_match_jax(argv):
    """Override strings with and without '=', through the Optional fields'
    annotation-driven coercion; the quirks too: '1e-4' stays a string in a
    float field, 'yes' a string in a string field, '~' a string in an
    Optional[str] field that holds a string, '1' an int in a float field."""
    assert config.parse_cli_overrides(argv) == jax_config.parse_cli_overrides(argv)
    overrides = config.parse_cli_overrides(argv)
    files = _files("flow_supervised", "pspnet", "flow")
    ours = config.load_config(files, overrides)
    _same(config.config_to_dict(ours),
          jax_config.config_to_dict(jax_config.load_config(files, overrides)))
    if argv[0] == "--model.arch":
        assert ours.model.optim.lr == "1e-4" and ours.trainer.limit_val_batches == 2
        assert ours.model.int8_decode is True and ours.data.data_variant == "~"
        assert ours.trainer.run_name == "yes" and ours.data.train_h == 96
    else:
        assert ours.model.optim.lr == 1e-4 and ours.model.int8_decode is False
        assert ours.model.power == 1 and type(ours.model.power) is int
    # a whole sub-config on the command line replaces the dataclass by a dict
    whole = {"model.contrastive": "{num_queries: 16}"}
    ours = config.load_config(files, whole)
    assert ours.model.contrastive == {"num_queries": 16} == jax_config.load_config(
        files, whole).model.contrastive
    with pytest.raises(SystemExit):
        config.parse_cli_overrides(["model.arch", "vit"])
    with pytest.raises(SystemExit):
        config.parse_cli_overrides(["--model.arch"])
    with pytest.raises(KeyError):
        config.load_config([], {"model.no_such_field": "1"})


def test_predict_v_id_link_model_side_first():
    """apply_links' predict_v_id rule: whichever side differs from the
    default wins, the model side checked first."""
    for overrides in ({"model.predict_v_id": "a"}, {"data.predict_v_id": "b"},
                      {"model.predict_v_id": "a", "data.predict_v_id": "b"}, {}):
        ours = config.load_config([], overrides)
        ref = jax_config.load_config([], overrides)
        assert ours.model.predict_v_id == ref.model.predict_v_id
        assert ours.data.predict_v_id == ref.data.predict_v_id
    assert config.load_config([], {"model.predict_v_id": "a",
                                   "data.predict_v_id": "b"}).data.predict_v_id == "a"


SCALARS = ["1e-4", "1.0e-4", "1.0e4", "yes", "No", "on", "OFF", "True", "~", "null", "", "0.5",
           "80", "010", "0x1F", "0b101", "1_000", "1:30", ".5", "-.inf", "+1", "09", "1.",
           "[1.0, 1.25]", "[2, 3, 4, 5]", "{lr: 0.0001, momentum: 0.9}", "{a, b}",
           "'it''s'", '"a\\tb"', "https://x.y", "a #comment", "a#b", "-1", "[a: 1, b]"]


@pytest.mark.parametrize("text", SCALARS)
def test_yaml_scalars_match_pyyaml(text):
    ours, ref = yaml_subset.load(text), yaml.safe_load(text)
    if ref != ref:  # nan
        assert ours != ours
        return
    _same(ours, ref, repr(text))


def test_yaml_reader_matches_pyyaml_on_the_configs(tmp_path):
    """Every configs/*.yaml, and yaml.dump of the JAX CLI tests' mini config
    (tests/test_cli.py::_mini_config) for each method, read as
    yaml.safe_load reads them."""
    names = sorted(n for n in os.listdir(CONFIGS) if n.endswith(".yaml"))
    assert len(names) == 11
    for name in names:
        with open(os.path.join(CONFIGS, name)) as f:
            text = f.read()
        _same(yaml_subset.load(text), yaml.safe_load(text), name)
    for method in METHODS:
        path = test_cli._mini_config(tmp_path, str(tmp_path / "root"), method)
        with open(path) as f:
            text = f.read()
        _same(yaml_subset.load(text), yaml.safe_load(text), method)
        _same(config.config_to_dict(config.load_config([path])),
              jax_config.config_to_dict(jax_config.load_config([path])), method)
    text = yaml.dump({"model": {"test_scales": [1.0, 1.25], "arch": "vit"},
                      "data": {"data_classes_ignore": [2, 3], "data_root": "/x y/z"}})
    _same(yaml_subset.load(text), yaml.safe_load(text), "block sequences")


@pytest.mark.parametrize("text,what", [
    ("a: &x 1", "anchor"), ("a: *x", "alias"), ("a: !!float 1", "tag"),
    ("a: |\n  x", "block scalar"), ("a: >\n  x", "block scalar"),
    ("a: 1\n---\nb: 2", "several documents"), ("? a\n: b", "complex mapping key"),
    ("a: 2001-12-14", "timestamp"), ("<<: 1", "merge key"), ("%YAML 1.1\n---\na: 1", "directive"),
    ("\ta: 1", "tab"), ("a: [1,\n  2]", "unclosed flow collection"),
    ("a: 'x\n  y'", "multi-line quoted scalar")])
def test_yaml_outside_the_subset_raises_naming_it(text, what):
    with pytest.raises(yaml_subset.YAMLSubsetError, match=what):
        yaml_subset.load(text)


def _leaf_paths(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaf_paths(v, f"{prefix}{f.name}.")
        else:
            yield prefix + f.name


def test_every_field_is_read_or_raises():
    """Every field of the seven dataclasses is in FIELDS (with what reads
    it) or in NOT_READ (with its ROADMAP item), not both; "fit:" entries
    name FitConfig fields, "linked:" ones a field apply_links copies; a
    NOT_READ field set away from what the port accepts raises in fit_config
    (and so in the Runner, which calls it)."""
    paths = set(_leaf_paths(config.Config()))
    assert set(jax_config.config_to_dict(jax_config.Config())) == {
        p.split(".")[0] for p in paths if "." in p} | {p for p in paths if "." not in p}
    assert not set(FIELDS) & set(NOT_READ)
    assert set(FIELDS) | set(NOT_READ) == paths
    fit_fields = {f.name for f in dataclasses.fields(FitConfig)}
    for path, reader in FIELDS.items():
        kind, _, target = reader.partition(":")
        assert kind in ("fit", "runner", "main", "linked"), (path, reader)
        if kind == "fit":
            assert target.split(".")[0] in fit_fields, path
        if kind == "linked":
            cfg = config.Config()
            source = get_dotted(cfg, target)
            config._set_dotted(cfg, target, {str: "x", bool: not source,
                                             int: 7, float: 7.5}[type(source)]
                               if target != "model.arch" else "vit")
            config.apply_links(cfg)
            assert get_dotted(cfg, path) == get_dotted(cfg, target), path
    bad = {"model.remat": "true", "model.int8_encode": "true",
           "data.normalize_on_device": "true", "trainer.num_devices": "2"}
    assert set(bad) == set(NOT_READ)
    for path, value in bad.items():
        assert NOT_READ[path][0] in ("13d", "14")
        with pytest.raises(NotImplementedError, match=f"ROADMAP item {NOT_READ[path][0]}"):
            fit_config(config.load_config([], {path: value}))
    fit_config(config.load_config([], {"trainer.num_devices": "1"}))


def test_fit_fields_each_move_their_fitconfig_field():
    """Each "fit:" field, set away from its value, moves the FitConfig
    field it maps to, before the links (the mapping is wired, not only
    equal on the configs)."""
    base = config.load_config(_files("contrastive", "pspnet", "flow"))
    ref = fit_config(base)
    for path, reader in FIELDS.items():
        if not reader.startswith("fit:") or path in ("model.test_h", "model.test_w"):
            continue
        cfg = config.load_config(_files("contrastive", "pspnet", "flow"))
        config._set_dotted(cfg, path, _moved(path, get_dotted(cfg, path)))
        name = reader[len("fit:"):]
        assert get_dotted(fit_config(cfg), name) != get_dotted(ref, name), path


def _moved(path, v):
    """A value of ``v``'s type other than ``v``."""
    if path == "model.optim.optim":
        return "Adam"
    if isinstance(v, bool):
        return not v
    if v is None or isinstance(v, int):
        return 3 if v is None else v + 1
    if isinstance(v, float):
        return v + 0.125
    if isinstance(v, str):
        return v + "x"
    return [0.5] if v and isinstance(v[0], float) else [1, 2]


def test_fitconfig_defaults_are_the_layered_yaml():
    """FitConfig has no defaults of its own; default_fit_config is fit_config
    of the flow_supervised PSPNet-50 layering (train_base +
    train_flow_supervised + dataset_flow + pspnet) with its test crop None,
    so that an override of the train crop moves the test crop as
    apply_links links them; overrides land on top."""
    with pytest.raises(TypeError):
        FitConfig()
    fc = fit_config(config.load_config(_files("flow_supervised", "pspnet", "flow")))
    assert (fc.test_h, fc.test_w) == (fc.train_h, fc.train_w) == (433, 433)
    defaults = default_fit_config()
    assert (defaults.test_h, defaults.test_w) == (None, None)
    assert dataclasses.replace(fc, test_h=None, test_w=None) == defaults
    moved = default_fit_config(train_h=65, train_w=65, lr=0.5)
    assert (moved.train_h, moved.test_h, moved.lr) == (65, None, 0.5)
    assert dataclasses.replace(moved, train_h=433, train_w=433, lr=fc.lr) == defaults
