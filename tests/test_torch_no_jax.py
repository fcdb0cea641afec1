"""``skoots_tpu_torch`` and ``chip_smoke.py`` stand alone: they import no
JAX, no flax, no yacs and nothing of the JAX package, and nothing on the
GPU path needs Pillow, PyYAML or msgpack at import time (the machine with
the card has none of them)."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "skoots_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "skoots_tpu", "PIL", "yaml",
           "msgpack", "yacs")

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of these now raises ImportError
import skoots_tpu_torch
names = [m.name for m in pkgutil.walk_packages(skoots_tpu_torch.__path__,
                                               'skoots_tpu_torch.')
         if not m.name.endswith('.__main__')]  # those run the CLIs
for name in names:
    importlib.import_module(name)
import chip_smoke
print(" ".join(names))
"""

# modules every later slice must keep reaching (the walk above visits all)
EXPECTED = {"skoots_tpu_torch.infer.engine", "skoots_tpu_torch.kernels.upsample",
            "skoots_tpu_torch.kernels.microbench", "skoots_tpu_torch.ops.flood_fill",
            "skoots_tpu_torch.tools.bench_fma_rate", "skoots_tpu_torch.tools.bench_loadfma",
            "skoots_tpu_torch.utils.device", "skoots_tpu_torch.experimental.data",
            "skoots_tpu_torch.experimental.eval", "skoots_tpu_torch.experimental.modifiers",
            "skoots_tpu_torch.experimental.sparse_engine",
            "skoots_tpu_torch.experimental.sparse_loss",
            "skoots_tpu_torch.train.generate_skeletons", "skoots_tpu_torch.utils.lee_thin",
            "skoots_tpu_torch.train.viz", "skoots_tpu_torch.tools.bench_train_kernels",
            "skoots_tpu_torch.utils.tiff", "skoots_tpu_torch.utils.host_lib",
            "skoots_tpu_torch.models.unext", "skoots_tpu_torch.models.registry",
            "skoots_tpu_torch.infer.perslice", "skoots_tpu_torch.utils.flood_and_stitch",
            "skoots_tpu_torch.utils.remove_margin", "skoots_tpu_torch.utils.renumber",
            "skoots_tpu_torch.utils.synthetic", "skoots_tpu_torch.tools.accuracy_campaign",
            "skoots_tpu_torch.parallel", "skoots_tpu_torch.parallel.mesh",
            "skoots_tpu_torch.parallel.distributed", "skoots_tpu_torch.infer.sharded",
            "skoots_tpu_torch.infer", "skoots_tpu_torch.ops", "skoots_tpu_torch.kernels",
            "skoots_tpu_torch.train", "skoots_tpu_torch.utils", "skoots_tpu_torch.models",
            "skoots_tpu_torch.ops.morphology", "skoots_tpu_torch.ops.cropper",
            "skoots_tpu_torch.infer.device_pipeline", "skoots_tpu_torch.utils.torch_compat",
            "skoots_tpu_torch.train.checkpoint", "skoots_tpu_torch.train.losses",
            "skoots_tpu_torch.models.spatial_embedding", "skoots_tpu_torch.infer.autoknobs",
            "skoots_tpu_torch.config", "skoots_tpu_torch.tools.bigvol_proof",
            "skoots_tpu_torch.tools.seam_bench_agreement",
            "skoots_tpu_torch.tools.bench_tail_head"}


def test_every_module_imports_without_jax_pil_yaml_msgpack():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 20 and EXPECTED <= names, EXPECTED - names


def _imports(path: Path):
    """(module, at top level?) for every import statement in a file."""
    tree = ast.parse(path.read_text())
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module, id(node) in top


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_anywhere(path):
    """Not even inside a function: the port never reaches the JAX package,
    nor Pillow (TIFF goes through ``utils/tiff.py``), nor yacs (a ``.trch``
    whose cfg is a pickled yacs node needs it only to unpickle)."""
    for mod, at_top in _imports(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "optax", "skoots_tpu", "PIL",
                            "yacs"), mod
        if at_top:
            assert root not in ("yaml", "msgpack"), mod


@pytest.mark.parametrize("alone", [True, False])
def test_chip_smoke_fails_without_a_gpu(tmp_path, alone):
    """Without a card -- and, alone in a directory, without the package --
    the smoke script exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
