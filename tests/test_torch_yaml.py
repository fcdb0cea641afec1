"""The port's own YAML reader (``skoots_tpu_torch/config.py::load_yaml``)
against ``yaml.safe_load``: the repo's cfg file, the cfg files the repo's
tests write, YAML 1.1 scalar resolution, the block and flow forms, and a
property over random cfg-shaped documents; anything beyond the subset
raises with its line number, and ``load_cfg_from_file`` needs no PyYAML."""

import math
import sys
from pathlib import Path

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from skoots_tpu_torch import config as C
from skoots_tpu_torch.config import YamlSubsetError, load_yaml

ROOT = Path(__file__).resolve().parent.parent
REPO_CFGS = sorted(p for p in ROOT.glob("runs/**/*.yaml"))

# the cfg documents the repo's tests write with yaml.safe_dump
# (tests/test_sparse.py, tests/test_train_e2e.py, tests/test_torch_train.py)
TEST_CFGS = [
    {"MODEL": {"DIMS": [4, 8, 16, 8, 4], "DEPTHS": [1, 1, 1, 1, 1], "OUT_CHANNELS": 4,
               "KERNEL_SIZE": 3},
     "TRAIN": {"TRAIN_DATA_DIR": ["data/sparse"], "TRAIN_SAMPLE_PER_IMAGE": [1],
               "TRAIN_STORE_DATA_ON_GPU": [False], "NUM_EPOCHS": 2, "SAVE_INTERVAL": 2,
               "SAVE_PATH": "models", "MAX_SKELETON_POINTS": 64,
               "LOSS_SKELETON_START_EPOCH": -1},
     "AUGMENTATION": {"CROP_WIDTH": 32, "CROP_HEIGHT": 32, "CROP_DEPTH": 8},
     "SKOOTS": {"VECTOR_SCALING": [8, 8, 4]},
     "EXPERIMENTAL": {"IS_SPARSE": True, "DIST_THR": 5.0}},
    {"MODEL": {"DIMS": [4, 8, 16, 8, 4], "DEPTHS": [1, 1, 1, 1, 1], "OUT_CHANNELS": 4,
               "KERNEL_SIZE": 3, "DTYPE": "float32"},
     "TRAIN": {"TRAIN_DATA_DIR": ["data"], "TRAIN_SAMPLE_PER_IMAGE": [2], "NUM_EPOCHS": 3,
               "SAVE_INTERVAL": 3, "SAVE_PATH": "models", "MAX_SKELETON_POINTS": 128,
               "LEARNING_RATE": 1e-2, "LOSS_SKELETON_START_EPOCH": -1,
               "INITIAL_SIGMA": [8.0, 8.0, 4.0], "VALIDATE_EPOCH_SKIP": 10},
     "AUGMENTATION": {"CROP_WIDTH": 32, "CROP_HEIGHT": 32, "CROP_DEPTH": 8,
                      "ELASTIC_RATE": 0.0, "AFFINE_RATE": 0.0, "NOISE_RATE": 0.0},
     "SKOOTS": {"VECTOR_SCALING": [8, 8, 4]}},
    {"SYSTEM": {"MESH_SPACE": 2}},
    {"MODEL": {"OUT_CHANNELS": 7}},
]


def test_repo_cfg_files_read_as_safe_load():
    assert REPO_CFGS, "no cfg YAML under runs/"
    for p in REPO_CFGS:
        text = p.read_text()
        assert load_yaml(text) == yaml.safe_load(text), p


@pytest.mark.parametrize("cfg", TEST_CFGS, ids=lambda c: ",".join(c))
@pytest.mark.parametrize("flow", [False, None, True], ids=["block", "mixed", "flow"])
def test_test_written_cfgs_read_as_safe_load(cfg, flow):
    text = yaml.safe_dump(cfg, default_flow_style=flow)
    assert load_yaml(text) == yaml.safe_load(text) == cfg


def test_load_cfg_from_file_needs_no_pyyaml(tmp_path, monkeypatch):
    """With ``yaml`` blocked, every cfg file of the repo merges to what the
    defaults merged with ``yaml.safe_load``'s result give."""
    want = {p: C.merge_from_dict(C.get_cfg_defaults(), yaml.safe_load(p.read_text()))
            for p in REPO_CFGS}
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError):
        import yaml as _  # noqa: F401
    for p, cfg in want.items():
        assert C.load_cfg_from_file(str(p)) == cfg


@pytest.mark.parametrize("text", [
    "1e-3", "1.0e-3", "1.0e3", "1.", ".5", "-.5e+2", "1_000.5", "190:20:30.15", ".inf",
    "-.Inf", "+.INF", "0", "-0", "007", "0o7", "0b1011", "-0x1F", "1_000", "190:20:30", "+12",
    "1:70", "yes", "No", "ON", "off", "True", "FALSE", "y", "n", "~", "null", "Null", "NULL",
    "", "none", "a b", "a#b", "a:b", "-a", "'1e-3'", "'it''s'", '"a\\tb\\u00e9\\x41"', "'#x'",
    "foo # comment", "[]", "{}", "[1, 'a, b', [2.5, ~], {k: v}]", "[yes, no, 0x10, 1e3]",
], ids=repr)
def test_scalars_resolve_as_pyyaml(text):
    doc = f"KEY: {text}\n"
    assert load_yaml(doc) == yaml.safe_load(doc)


def test_nan_resolves_as_pyyaml():
    assert math.isnan(load_yaml("k: .NaN")["k"]) and math.isnan(yaml.safe_load("k: .NaN")["k"])


def test_block_and_flow_forms():
    doc = """\
---
# a comment line
A:
  LIST:
  - 1
  - - 2.0
    - x
  -
    - nested
  - {a: 1}
  - k: v
    k2: [3,
      4]  # flow over two lines
  INDENTED:
    - 5
  EMPTY:
  'QUOTED KEY': "v"
B: [[0.66, 200], [0.5, 20000]]
...
"""
    assert load_yaml(doc) == yaml.safe_load(doc)
    assert load_yaml("") is None and load_yaml("# nothing\n") is None
    assert load_yaml("- a\n- b\n") == ["a", "b"]


@pytest.mark.parametrize("doc,line", [
    ("A: 1\nB: &x 2\n", 2),
    ("A: 1\nB: *x\n", 2),
    ("A: !!str 1\n", 1),
    ("A: |\n  text\n", 1),
    ("A: >\n  text\n", 1),
    ("A: plain\n  continued\n", 2),
    ("A:\n\t- 1\n", 2),
    ("? complex\n: value\n", 1),
    ("A: 1\n---\nB: 2\n", 2),
    ("%YAML 1.1\n---\nA: 1\n", 1),
    ("A: 2001-12-14\n", 1),
    ("A: <<\n", 1),
    ("A: [1, 2\n", 1),
    ("A: 'open\n", 1),
    ("A: \"\\q\"\n", 1),
    ("A: b: c\n", 1),
    ("A:\n  B: 1\n C: 2\n", 3),
    ("just a line\nA: 1\n", 2),
    ("A: - b\n", 1),
    ("A: [a: b]\n", 1),
    ("A: [?x]\n", 1),
], ids=repr)
def test_beyond_the_subset_raises_with_its_line(doc, line):
    with pytest.raises(YamlSubsetError, match=f"^line {line}:"):
        load_yaml(doc)


_KEYS = st.from_regex(r"[A-Z][A-Z0-9_]{0,14}", fullmatch=True)
_TEXT = st.text(st.characters(min_codepoint=32, max_codepoint=126), max_size=12)
_SCALARS = st.one_of(st.none(), st.booleans(), st.integers(-10**12, 10**12),
                     st.floats(allow_nan=False, width=64), _TEXT)
_VALUES = st.one_of(_SCALARS, st.lists(_SCALARS, max_size=5),
                    st.lists(st.lists(_SCALARS, min_size=1, max_size=3), max_size=4))


@settings(max_examples=150, deadline=None)
@given(cfg=st.dictionaries(_KEYS, st.dictionaries(_KEYS, _VALUES, max_size=6), max_size=5),
       flow=st.sampled_from([False, None, True]), sort_keys=st.booleans())
def test_random_cfg_documents_read_back(cfg, flow, sort_keys):
    """``yaml.safe_dump`` of a random cfg-shaped dict (sections of keys with
    scalars, lists and lists of lists) reads back equal."""
    text = yaml.safe_dump(cfg, default_flow_style=flow, sort_keys=sort_keys, width=10**6)
    assert load_yaml(text) == yaml.safe_load(text) == cfg
