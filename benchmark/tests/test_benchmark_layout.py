"""``BENCHMARK.json`` against the contract, and every piece found by name:
a new cell, mix, configuration or metric is a new file, and no file that is
there changes."""

import hashlib
import json
import re
import shutil

import pytest

from benchmark import harness

SPEC = json.load(open(harness.ROOT / "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    assert 1 <= cells <= 24
    # the check's time with the full 24 cells fits 43,200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_texts():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
            for key in ("why", "layer", "source"):
                if key in e and group in ("configs", "workloads", "per_layer"):
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    bounds = {m["name"]: m["bound"] for m in SPEC["end_to_end"]}
    assert "setup_s" in bounds and bounds["setup_s"] <= 0.25
    assert all(0.01 <= b <= 0.25 for b in bounds.values())
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in bounds


def test_every_piece_loads_by_name():
    for c in SPEC["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        conf = harness.load_json("configs", c["name"])
        assert conf["reduced"] == c["reduced"]
        if "weights" in conf:
            assert (harness.BENCH / conf["weights"]).exists()
    configs = {c["name"] for c in SPEC["configs"]}
    used = set()
    for w in SPEC["workloads"]:
        wl = harness.load_json("workloads", w["name"])
        assert (wl["config"], wl["traffic"], wl["chips"], wl["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        assert w["config"] in configs and w["chips"] == 1
        used.add(w["config"])
        mix = harness.load_json("traffic", w["traffic"])
        assert hasattr(harness.load_module("traffic", mix["kind"]), "make")
        assert hasattr(harness.load_module("entries", wl["entry"]), "run")
        reported = harness.cell_metrics(SPEC, w["name"], False)
        names = {m["name"] for m in reported}
        assert "setup_s" in names and len(names) >= 2
        assert harness.cell_metrics(SPEC, w["name"], True)
    assert used == configs
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
        assert set(m.get("workloads", cells)) <= cells
    for fam in harness.names("kernels", ".py"):
        mod = harness.load_module("kernels", fam)
        assert re.compile(mod.PATTERN) and callable(mod.work)


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_mix_config_and_metric_are_new_files_only(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digest(root)
    (root / "traffic" / "tubes256.json").write_text(json.dumps(
        dict(harness.load_json("traffic", "tubes512"), shape=[256, 256, 256], tubes=12)))
    (root / "configs" / "skoots_unext_k9.json").write_text(json.dumps(
        dict(harness.load_json("configs", "skoots_unext"), reduced=[])))
    (root / "workloads" / "unext_seg_tubes256.json").write_text(json.dumps(
        dict(harness.load_json("workloads", "unext_seg_tubes512"), traffic="tubes256",
             config="skoots_unext_k9")))
    (root / "metrics" / "blocks_per_s.py").write_text(
        "def read(raw):\n    return raw['blocks'] / raw['window_s']\n")
    assert "unext_seg_tubes256" in harness.names("workloads", ".json", root)
    assert "blocks_per_s" in harness.names("metrics", ".py", root)
    assert harness.load_module("metrics", "blocks_per_s", root).read(
        {"blocks": 6, "window_s": 3.0}) == 2.0
    wl = harness.load_json("workloads", "unext_seg_tubes256", root)
    assert harness.load_json("traffic", wl["traffic"], root)["shape"] == [256, 256, 256]
    assert harness.load_json("configs", wl["config"], root)["cfg"]["MODEL"]["DIMS"]
    e2e = [dict(m, workloads=m["workloads"] + ["unext_seg_tubes256"])
           if "seg_mvox_s" == m["name"] else m for m in SPEC["end_to_end"]]
    spec = dict(SPEC, end_to_end=e2e, workloads=SPEC["workloads"] + [
        {"name": "unext_seg_tubes256", "config": "skoots_unext_k9", "traffic": "tubes256",
         "chips": 1, "why": "w"}],
        per_layer=SPEC["per_layer"] + [{"name": "blocks_per_s", "unit": "1/s",
                                        "better": "higher", "source": "host_clock",
                                        "layer": "pipeline", "moves": "seg_mvox_s"}])
    layer = {m["name"] for m in harness.cell_metrics(spec, "unext_seg_tubes256", True)}
    assert "blocks_per_s" in layer
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_limits_are_set(cell):
    wl = harness.load_json("workloads", cell)
    assert wl["limits"] and all(v >= 0 for v in wl["limits"].values())
