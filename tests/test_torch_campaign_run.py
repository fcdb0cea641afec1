"""One scenario of the port's accuracy campaign run end to end on the CPU
(build the phantoms, write the cfg, one training step through
``skoots-train-torch``, segment and score), and the tool's summary: a
``result.json`` with the JAX tool's keys and the device's."""

import json
import os
import shutil

import pytest
import torch

from skoots_tpu_torch.tools import accuracy_campaign as ac

JAX_KEYS = {"scenario", "f1_at_iou50", "mean_iou", "tp", "fp", "fn", "gt_instances",
            "pred_instances", "checkpoint", "ok", "bar", "wall_s"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_separated_scenario_on_the_cpu(tmp_path):
    """One epoch of one step: the model is untrained, so only the record is
    checked (every dense scenario carries ``diag_semantic``; the checkpoint
    relative to the outdir), then ``main`` rescoring the checkpoint folds
    the result into ``campaign.json``."""
    r = ac.run_scenario("separated", str(tmp_path), 1, 1, device="cpu")
    on_disk = json.loads((tmp_path / "separated" / "result.json").read_text())
    assert on_disk == r
    assert JAX_KEYS <= set(r)
    assert set(r) - JAX_KEYS <= {"diag_semantic", "device", "name", "power_limit", "steps"}
    assert r["device"] == "cpu" and r["steps"] == 1 and r["bar"] == 0.8
    assert r["gt_instances"] == 4 and r["checkpoint"].endswith(".skoots")
    assert not os.path.isabs(r["checkpoint"]) and (tmp_path / r["checkpoint"]).is_file()
    assert r["ok"] == (r["f1_at_iou50"] >= 0.8)
    assert set(r["diag_semantic"]) == {"precision", "recall", "pred_fg_frac", "gt_fg_frac"}
    rc = ac.main(["--scenario", "separated", "--outdir", str(tmp_path), "--rescore",
                  "--device", "cpu"])
    summary = json.loads((tmp_path / "campaign.json").read_text())
    assert [x["scenario"] for x in summary["results"]] == ["separated"]
    assert summary["results"][0]["checkpoint"] == r["checkpoint"]
    assert summary["results"][0]["steps"] == 0  # rescored: no training
    assert rc == (0 if summary["ok"] else 1)


def test_perslice_alone_finds_the_aniso_checkpoint_in_its_outdir(tmp_path, monkeypatch):
    """``--scenario perslice`` alone reads the aniso checkpoint from
    ``<outdir>/aniso/result.json``, resolved against the outdir it is given
    (so a copied or moved outdir still finds its own model); a recorded
    absolute path is kept as it is."""
    seen = []
    monkeypatch.setattr(ac, "run_scenario", lambda s, outdir, *a, **k: seen.append(a[2]) or {
        "scenario": s, "ok": True})
    for rel in ("aniso/models/a.skoots", os.path.abspath("/elsewhere/b.skoots")):
        old = tmp_path / "old"
        (old / "aniso").mkdir(parents=True)
        record = {"scenario": "aniso", "ok": True, "checkpoint": rel}
        (old / "aniso" / "result.json").write_text(json.dumps(record))
        moved = tmp_path / "moved"
        shutil.move(str(old), str(moved))
        ac.main(["--scenario", "perslice", "--outdir", str(moved), "--device", "cpu"])
        shutil.rmtree(moved)
    assert seen == [os.path.join(str(tmp_path / "moved"), "aniso/models/a.skoots"),
                    os.path.abspath("/elsewhere/b.skoots")]
