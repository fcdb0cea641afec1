"""Every entry of the CUDA library is called with its operands' card
current (``kernels/_build.py::on_device``): the library keys its
per-device set-up on the current device, so a kernel on ``cuda:1``
launched while ``cuda:0`` is current would get ``cuda:0``'s. The guard's
logic is checked here with a stand-in for ``torch.cuda.device``; that
every wrapper calling into the library carries it, by reading the
sources; ``tests/test_torch_infer_cuda.py::
test_cuda_kernels_on_a_card_that_is_not_current`` runs them on a second
card."""

import ast
from pathlib import Path

import pytest
import torch

from skoots_tpu_torch.kernels import _build

PORT = Path(__file__).resolve().parent.parent / "skoots_tpu_torch"


class _Fake:
    def __init__(self, device):
        self.device = torch.device(device)


def test_on_device_makes_the_operands_card_current(monkeypatch):
    entered = []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(self.device)

        def __exit__(self, *exc):
            entered.append("exit")
            return False

    monkeypatch.setattr(torch.cuda, "device", Guard)

    @_build.on_device
    def wrapper(t, scale=1):
        entered.append(("call", scale))
        return scale

    assert wrapper(_Fake("cpu"), scale=2) == 2
    assert entered == [("call", 2)]
    entered.clear()
    assert wrapper(_Fake("cuda:1"), 3) == 3
    assert entered == [torch.device("cuda", 1), ("call", 3), "exit"]
    assert wrapper.__name__ == "wrapper"


def _library_callers(path: Path):
    """(function name, decorated with on_device?) for every function of a
    source that calls into the CUDA library (``_build.library()`` or a
    ``lib.skoots_*`` entry)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        calls = any(
            isinstance(n, ast.Attribute) and (
                n.attr == "library" and isinstance(n.value, ast.Name) and n.value.id == "_build"
                or n.attr.startswith("skoots_"))
            for n in ast.walk(node))
        if calls:
            guarded = any(ast.unparse(d) == "_build.on_device" for d in node.decorator_list)
            yield node.name, guarded


@pytest.mark.parametrize("path", [p for p in sorted((PORT / "kernels").glob("*.py"))
                                  + sorted((PORT / "tools").glob("*.py"))
                                  if p.name != "_build.py"],  # the loader itself
                         ids=lambda p: str(p.relative_to(PORT)))
def test_every_library_call_is_guarded(path):
    unguarded = [name for name, guarded in _library_callers(path) if not guarded]
    assert not unguarded, f"{path.name}: {unguarded} call the library without on_device"


def test_the_wrappers_are_found():
    found = {name for p in (PORT / "kernels").glob("*.py") for name, _ in _library_callers(p)}
    assert {"_dwconv3d_fwd", "dwconv3d_wgrad", "_mlp_fwd", "_ln_head_fwd", "propagate",
            "bake_skeleton_kernel", "_upsample2x_fwd", "fma_chain", "loadfma"} <= found
