"""The port's YAML loader (``mipsfusion_tpu_torch/config.py``, no PyYAML)
against the JAX package's ``load_config`` (PyYAML): the same dicts for
every config it reads, and an error, never a misreading, outside its
subset."""

import glob
import os

import pytest

from mipsfusion_tpu.config import apply_overrides as japply
from mipsfusion_tpu.config import load_config as jload
from mipsfusion_tpu_torch.config import (FLAGSHIP_ORBIT, YamlSubsetError,
                                         apply_overrides, load_config,
                                         parse_yaml_subset,
                                         update_recursive)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTHETIC = sorted(glob.glob(os.path.join(ROOT, "configs/synthetic/*.yaml")))


@pytest.mark.parametrize("path", [os.path.join(ROOT, "configs/base.yaml")]
                         + SYNTHETIC, ids=os.path.basename)
def test_load_config_matches_jax(path, monkeypatch):
    """base.yaml and every synthetic yaml (inherit_from chains resolved
    from the repo root): the same dict, types included."""
    monkeypatch.chdir(ROOT)
    ref, out = jload(path), load_config(path)
    assert out == ref
    assert repr(out) == repr(ref)           # bool vs int, float vs int


def test_every_other_config_matches_or_raises(monkeypatch):
    """Every file in configs/ (the scene files' block sequences
    included) reads as PyYAML reads it: the same dict, types included."""
    monkeypatch.chdir(ROOT)
    paths = sorted(glob.glob(os.path.join(ROOT, "configs/**/*.yaml"),
                             recursive=True))
    assert len(paths) == 35
    for path in paths:
        assert repr(load_config(path)) == repr(jload(path)), path
    assert load_config("configs/ScanNet/scene0000.yaml")["mapping"][
        "bound"] == [[-0.1, 8.6], [-0.1, 8.9], [-0.3, 3.3]]


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n  - 2",                     # deeper than the key
    "a:\n- 1\n- 2\nb: 3",                  # at the key's indent
    "a:\n- - -0.1\n  - 8.6\n- - 1\n  -   2",  # nested, compact
    "a:\n  -   - 1\n      - 2\n  - - 3",     # nested, wider gaps
    "a:\n-\n  - 1\n  - 2\n-\n- 3",          # an empty item, a deeper one
    "a:\n    - 1\n    # note\n\n    - [2, [3]]\n    - 'x'  # c",
    "x:\n  a:\n  - 1\n  b:\n    - - 2\n  c: 3",
    "a:\n- -1\n- .5\n- ~\n- True\n- \"q\"",
])
def test_block_sequences_as_pyyaml_reads_them(text):
    import yaml
    assert repr(parse_yaml_subset(text)) == repr(yaml.safe_load(text))

def test_flagship_orbit_is_the_merged_yaml(monkeypatch):
    monkeypatch.chdir(ROOT)
    assert load_config("configs/synthetic/orbit.yaml") == FLAGSHIP_ORBIT


@pytest.mark.parametrize("text,value", [
    ("a: 1", 1), ("a: -3", -3), ("a: 1.5", 1.5), ("a: 1.0e-5", 1e-5),
    ("a: -2.5E+3", -2500.0), ("a: .5", 0.5), ("a: 7.", 7.0),
    ("a: True", True), ("a: off", False), ("a: ~", None), ("a:", None),
    ("a: null", None), ("a: .inf", float("inf")), ("a: plain text", "plain text"),
    ("a: path/to/x.yaml", "path/to/x.yaml"), ('a: "q # not a comment"',
                                             "q # not a comment"),
    ("a: 'it''s'", "it's"), ('a: "tab\\there"', "tab\there"),
    ("a: [1, [2.5, -3], 'x', True, [], [[]]]",
     [1, [2.5, -3], "x", True, [], [[]]]),
    ("a: 3  # trailing comment", 3), ("a: [1, 2] # c", [1, 2]),
])
def test_scalars_and_flow_lists_as_pyyaml_reads_them(text, value):
    import yaml
    assert parse_yaml_subset(text) == {"a": value} == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a:\n  - b: 1",                  # a mapping inside a sequence
    "a:\n  -\n    b: 1",
    "a:\n- 1\n  - 2",                # an item continued deeper
    "a:\n  - 1\n b: 2",
    "a: {b: 1}",                     # flow mapping
    "a: &x 1",                       # anchor
    "a: *x",                         # alias
    "a: !!float 1",                  # tag
    "a: |\n  text",                  # block scalar
    "a: 1e-5",                       # PyYAML reads a string here
    "a: -.5", "a:\n- +.5",
    "a: 0x1f", "a: 017", "a: 1:30",
    "a: 1\na: 2",                    # duplicate key
    "a: [1, 2",                      # unterminated flow list
    "a: [1,, 2]",
    "a: b: c",
    "a: 1\n  b: 2",                  # a value continued on the next line
    "a:\n\tb: 1",                    # tab indentation
    "---\na: 1",
    "  a: 1",
    "- 1",
])
def test_outside_the_subset_raises(text):
    with pytest.raises(YamlSubsetError):
        parse_yaml_subset(text)


def test_update_recursive_and_apply_overrides_match_jax(monkeypatch):
    monkeypatch.chdir(ROOT)
    cfg = load_config("configs/synthetic/outback.yaml")
    over = {"mapping.iters": 5, "tracking.RO.particle_size": 64,
            "new.deep.key": [1, 2], "seed": 3}
    assert apply_overrides(cfg, over) == japply(cfg, over)
    assert cfg == jload("configs/synthetic/outback.yaml")   # not mutated
    from mipsfusion_tpu.config import update_recursive as jupdate
    a, b = {"x": {"y": 1, "z": 2}, "w": 1}, {"x": {"y": 5}, "w": {"v": 1}}
    a2 = {"x": {"y": 1, "z": 2}, "w": 1}
    update_recursive(a, b)
    jupdate(a2, b)
    assert a == a2
