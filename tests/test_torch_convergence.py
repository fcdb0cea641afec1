"""Slow, on the card: the port must learn skeleton-guided segmentation.

The convergence proof (``skoots_tpu_torch/tools/convergence.py``, the
port of ``tools/convergence.py``) through the real CLIs at the JAX slow
test's settings (``tests/test_convergence.py``: 150 epochs of 10 steps),
held to the tool's bars: F1 at IoU 0.5 >= 0.8, mean IoU >= 0.7. Imports no
JAX; on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_convergence.py -m slow
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.slow
@pytest.mark.cuda
def test_port_learns_tube_segmentation(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    out = tmp_path / "conv"
    proc = subprocess.run(
        [sys.executable, "-m", "skoots_tpu_torch.tools.convergence", "--epochs", "150",
         "--steps-per-epoch", "10", "--outdir", str(out), "--device", "cuda"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(ROOT)},
        capture_output=True, text=True, timeout=7200,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    result = json.loads((out / "result.json").read_text())
    assert result["f1_at_iou50"] >= 0.8, result
    assert result["mean_iou"] >= 0.7, result
