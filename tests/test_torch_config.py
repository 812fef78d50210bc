"""The port's config (mammo_clip_tpu_torch/core/config.py) is a plain-Python copy
of the JAX package's: the canonical configs and every YAML in configs/ load to
the same dicts, and overrides parse the same way, with or without PyYAML,
except for the numbers that PyYAML leaves as text (fault R5 of the reference:
``1e-4`` is a float in the port and the string '1e-4' in the JAX package)."""

import glob
import math
import os
import sys

import pytest
import yaml

from mammo_clip_tpu.core import config as jax_config
from mammo_clip_tpu_torch.core import config

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


@pytest.mark.parametrize("variant", ["b2", "b5"])
def test_default_pretrain_config_matches_jax(variant):
    assert (config.default_pretrain_config(variant).to_dict()
            == jax_config.default_pretrain_config(variant).to_dict())


def test_tiny_config_and_overrides_match_jax():
    ours, ref = config.tiny_test_config(), jax_config.tiny_test_config()
    assert ours.to_dict() == ref.to_dict()
    ov = ["model.image_encoder.remat=true", "optimizer.lr=1e-4", "data.new_key=[1, 2]"]
    got, want = ours.apply_overrides(ov).to_dict(), ref.apply_overrides(ov).to_dict()
    # R5: PyYAML reads 1e-4 as text, so the JAX config carries the string; the port
    # does not inherit that and carries the float.
    assert (got["optimizer"].pop("lr"), want["optimizer"].pop("lr")) == (1e-4, "1e-4")
    assert got == want


# Override spellings by group: the port must give what yaml.safe_load gives.
SPELLINGS = {
    "bools": ["true", "True", "TRUE", "false", "False", "FALSE", "yes", "Yes", "YES", "no",
              "No", "NO", "on", "On", "ON", "off", "Off", "OFF", "tRuE", "y", "n"],
    "nulls": ["", "~", "null", "Null", "NULL", "  "],
    "ints": ["0", "7", "-3", "+5", "0x1F", "-0x1f", "010", "09", "0o17"],
    "floats": ["1.5", "-0.25", "5.0e-5", "1.0e+3", "1.", ".5", "6.8523015e+5", ".inf",
               "-.inf", "+.inf", ".Inf", ".nan", ".NaN", "0.", "-0.0"],
    "strings": ["'False'", '"1e-4"', "'it''s'", '"a\\"b"', '"tab\\tx"', "synthetic://",
                "efficientnet-b0", "x.csv", "b5", "float32", "a b", "1.2.3", "1-2"],
    "flow": ["[1, 2]", "[]", "{}", '[true, no, ~, 1.5, "s"]', '{"a": [1, {"b": null}]}',
             "{a: 1, b: off}", '[{"csv": "x.csv", "image_dir": "synthetic://"}]',
             "[a, [b, [c]]]", "{k: [x, y], j: {m: ~}}", "[ 1 , 2 ]", "[0x10, 010]", "{a: }",
             "[synthetic://, 'q']", '{"a":1}'],
}
# R5: numbers PyYAML leaves as text (an exponent without a dot or sign, a
# signed leading dot); the port reads them as the floats they spell.
R5_FLOATS = {"1e-4": 1e-4, "5e-5": 5e-5, "1E3": 1e3, "1.0e4": 1e4, "1e4": 1e4, "-.5": -0.5,
             "[0x10, 1e-4]": [16, 1e-4]}
# YAML 1.1 number forms the port does not read: binary, sexagesimal and
# "_"-grouped numbers stay text (no config or override of the repo spells one).
NUMBERS_KEPT_AS_TEXT = ["0b101", "190:20:30", "-1:30", "190:20:30.15", "1_000", "1_0.5"]


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


@pytest.fixture(params=[False, True], ids=["with_yaml", "yaml_blocked"])
def parse(request, monkeypatch):
    """The port's override parser, with PyYAML importable or blocked."""
    if request.param:
        monkeypatch.setitem(sys.modules, "yaml", None)  # `import yaml` raises
    return config._parse_value


@pytest.mark.parametrize("group", sorted(SPELLINGS))
def test_override_values_parse_as_yaml_safe_load(group, parse):
    for text in SPELLINGS[group]:
        got, want = parse(text), yaml.safe_load(text)
        assert _same(got, want), (text, got, want)


def test_override_numbers_that_pyyaml_leaves_as_text_are_floats(parse):
    for text, value in R5_FLOATS.items():
        assert _same(parse(text), value), text
        want = yaml.safe_load(text)  # what the JAX package's overrides give (R5)
        assert not _same(want, value), (text, want)
        assert jax_config.Config().apply_overrides([f"k={text}"])["k"] == want


def test_override_number_forms_the_port_does_not_read_stay_text(parse):
    for text in NUMBERS_KEPT_AS_TEXT:
        assert parse(text) == text
        assert isinstance(yaml.safe_load(text), (int, float)), text


def test_override_false_turns_the_fused_route_off_without_yaml(monkeypatch):
    """Fault 3.1: without PyYAML the port used to read ``False`` as the string
    'False', which is truthy, so the fused route stayed on."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    cfg = config.tiny_test_config()
    for text in ("False", "false", "no", "off", "OFF", "~"):
        out = cfg.apply_overrides([f"model.image_encoder.fused_mbconv={text}"])
        assert out.model.image_encoder.fused_mbconv in (False, None), text
    entry = '[{"csv": "x.csv", "image_dir": "synthetic://"}]'
    out = cfg.apply_overrides([f"data.train={entry}", "optimizer.lr=1e-4"])
    assert out.data.train == [{"csv": "x.csv", "image_dir": "synthetic://"}]
    assert out.optimizer.lr == 1e-4


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(CONFIG_DIR, "**", "*.yaml"),
                                                  recursive=True)))
def test_yaml_configs_load_like_jax(path, tmp_path):
    ours = config.load_config(path)
    assert ours.to_dict() == jax_config.load_config(path).to_dict()
    out = tmp_path / "round_trip.yaml"
    config.save_config(ours, str(out))
    assert config.load_config(str(out)).to_dict() == ours.to_dict()
