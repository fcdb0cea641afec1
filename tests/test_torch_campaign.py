"""The port's accuracy campaign tool (``skoots_tpu_torch/tools/
accuracy_campaign.py``) against the JAX package's (``tools/
accuracy_campaign.py``): the same phantoms, the same cfg files (the
port's YAML writer against ``yaml.safe_dump``, byte for byte), the same
scores. The aniso phantom (22 s a package) is in
``tests/test_torch_campaign_aniso.py`` and one CPU run of a scenario in
``tests/test_torch_campaign_run.py``, so each file stays short."""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from skoots_tpu_torch.config import dump_yaml, load_yaml
from skoots_tpu_torch.tools import accuracy_campaign as ac

ROOT = Path(__file__).resolve().parents[1]


def jax_campaign():
    """The JAX package's tool (a script under ``tools/``, not a package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_accuracy_campaign", ROOT / "tools" / "accuracy_campaign.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: on one thread, so the suite's parallel workers do
    not wait on each other's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_same_phantom(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert sorted(a[2]) == sorted(b[2])
    for k in a[2]:
        np.testing.assert_array_equal(a[2][k], b[2][k])


@pytest.mark.parametrize("scenario", ["separated", "touching", "blobs", "sparse"])
def test_phantom_equals_jaxs(scenario):
    """Image (with the EM-realism stack), labels and skeletons: equal."""
    assert_same_phantom(ac._phantom(scenario, 100), jax_campaign()._phantom(scenario, 100))


def test_clean_phantom_equals_jaxs(monkeypatch):
    """``CAMPAIGN_REALISM=0`` keeps the clean generator's image in both."""
    monkeypatch.setenv("CAMPAIGN_REALISM", "0")
    a, b = ac._phantom("blobs", 101), jax_campaign()._phantom("blobs", 101)
    assert_same_phantom(a, b)
    np.testing.assert_array_equal(a[0], ac._phantom_clean("blobs", 101)[0])


@pytest.mark.parametrize("scenario", ac.SCENARIOS)
def test_write_cfg_is_jaxs_file(tmp_path, scenario):
    """The cfg file is byte for byte the one JAX's tool writes with
    ``yaml.safe_dump``, reads back (``load_yaml``) to JAX's dict, and the
    port's cfg loader takes it."""
    from skoots_tpu_torch.config import load_cfg_from_file

    args = (str(tmp_path / "train"), str(tmp_path / "models"), 150, scenario)
    ours = ac.write_cfg(str(tmp_path / "ours.yaml"), *args)
    theirs = jax_campaign().write_cfg(str(tmp_path / "jax.yaml"), *args)
    assert ours == theirs
    text = (tmp_path / "ours.yaml").read_text()
    assert text == (tmp_path / "jax.yaml").read_text()
    assert text == dump_yaml(theirs) == yaml.safe_dump(theirs)
    assert load_yaml(text) == theirs == yaml.safe_load(text)
    cfg = load_cfg_from_file(str(tmp_path / "ours.yaml"))
    assert cfg["MODEL"]["DIMS"] == [16, 32, 64, 32, 16]
    assert cfg["EXPERIMENTAL"]["IS_SPARSE"] == (scenario == "sparse")


def test_dump_yaml_equals_safe_dump_on_awkward_values():
    """Quoting, escapes, numbers, nesting and empty collections, as
    ``yaml.safe_dump`` writes them."""
    docs = [
        {"s": "hello world", "num": "1.0", "empty": "", "colon": "a: b", "dash": "- x",
         "lead": "-x", "quote": "it's", "tab": "tab\there", "uni": "é",
         "hash": "a #b", "bool": "yes", "null": "~", "hex": "0x1F", "date": "2020-01-01",
         "nested": [1, [2, 3.5], {"x": None, "y": True}], "e": {"d": [], "f": {}},
         "floats": [1e-5, 1e-3, 5e-4, 1e16, -2.5, math.inf, -math.inf]},
        [[0.66, 45], [0.5, 127]], {}, [], {"k": [[1, [2]], {"a": [3]}]},
    ]
    for doc in docs:
        assert dump_yaml(doc) == yaml.safe_dump(doc)
        assert load_yaml(dump_yaml(doc)) == doc


_scalars = (st.none() | st.booleans() | st.integers(-10 ** 12, 10 ** 12)
            | st.floats(allow_nan=False) | st.text(max_size=12))
_docs = st.recursive(
    _scalars,
    lambda inner: st.lists(inner, max_size=4)
    | st.dictionaries(st.text(max_size=8), inner, max_size=4),
    max_leaves=12)


@settings(max_examples=200, deadline=None)
@given(doc=st.dictionaries(st.text(max_size=8), _docs, max_size=5))
def test_dump_yaml_round_trips(doc):
    """``load_yaml(dump_yaml(x)) == x``, and PyYAML reads the text to the
    same value."""
    text = dump_yaml(doc)
    assert load_yaml(text) == doc
    assert yaml.safe_load(text) == doc


def test_score_equals_jaxs(rng):
    """The same F1, mean IoU and counts from the same masks: a prediction
    with one instance merged into another, one split, one missed and one
    spurious."""
    gt = np.zeros((24, 24, 8), np.int32)
    for i in range(6):
        gt[4 * i:4 * i + 3, 2:20, 1:7] = i + 1
    pred = gt.copy()
    pred[pred == 2] = 1                     # merged
    pred[12:15, 2:11, 1:7] = 9              # split
    pred[pred == 4] = 0                     # missed
    pred[:, 22:24, :] = 7                   # spurious
    noise = rng.random(gt.shape) < 0.02
    pred[noise] = 0
    want = jax_campaign().score(gt, pred)
    assert ac.score(gt, pred, device="cpu") == want
    assert want["tp"] > 0 and want["fp"] > 0 and want["fn"] > 0
    empty = np.zeros_like(gt)
    assert ac.score(gt, empty, device="cpu") == jax_campaign().score(gt, empty)
