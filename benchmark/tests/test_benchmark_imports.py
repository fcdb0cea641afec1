"""Nothing the harness or the reference imports is JAX or the JAX package
(top-level names compared whole), and the reference imports nothing of the
program."""

import ast
import json
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "skoots_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_names_jax():
    files = [p for p in harness.BENCH.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        for mod in _imports(p):
            assert mod.split(".")[0] not in FORBIDDEN, (p, mod)


def test_the_reference_imports_nothing_of_the_program():
    for p in (harness.BENCH / "reference").rglob("*.py"):
        for mod in _imports(p):
            assert mod.split(".")[0] not in FORBIDDEN | {"skoots_tpu_torch"}, (p, mod)


def test_loaded_modules_at_run_time():
    """Import every module of the harness and the program modules its
    entries use, in a fresh process: no forbidden top-level name loads, and
    the reference's own imports load no module of the program."""
    code = r"""
import json, sys
sys.path.insert(0, %r)
import benchmark.reference.ckpt, benchmark.reference.model, benchmark.reference.seg
import benchmark.reference.train, benchmark.reference.quant
banned = ('skoots_tpu_torch', 'skoots_tpu', 'jax', 'jaxlib', 'flax')
ref_only = sorted(m for m in sys.modules if m.split('.')[0] in banned)
from benchmark import harness, flops, weights
for kind in ('entries', 'metrics', 'kernels', 'traffic'):
    for name in harness.names(kind, '.py'):
        harness.load_module(kind, name)
import skoots_tpu_torch.infer.device_pipeline, skoots_tpu_torch.checkpoint, skoots_tpu_torch.models
import skoots_tpu_torch.train.data, skoots_tpu_torch.train.engine, skoots_tpu_torch.train.transforms
print(json.dumps({"ref": ref_only, "all": harness.forbidden_modules()}))
""" % str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"ref": [], "all": []}
