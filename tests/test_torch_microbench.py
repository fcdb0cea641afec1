"""The plain versions of the port's two microbenchmarks
(``kernels/microbench.py``) against the TPU tools' kernel bodies:
``tools/bench_vpu_pallas.py`` and ``tools/bench_loadfma.py`` are loaded
unchanged and their module-level kernels run through ``pl.pallas_call``
with VMEM block specs in interpret mode, as the tools call them."""

import importlib.util
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from skoots_tpu_torch.kernels.microbench import (
    COLS,
    SHAPE,
    fma_chain,
    fma_chain_ref,
    loadfma,
    loadfma_ref,
)

TOOLS = Path(__file__).resolve().parent.parent / "tools"
VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fma_chain_ref_matches_tool_kernel(dtype):
    """The tool's own inputs (a = 1.000001, b = 0.9999) over (64, 128) for
    512 x 16 steps: exact. f32 ends at 8224.267 (XLA on the CPU fuses the
    interpreter's x * a + b into one FMA per step, as the port's exact FMA
    rounds once); at bf16, a and b round to 1 and the chain saturates at
    256."""
    tool = _load("bench_vpu_pallas")
    jdt = getattr(jnp, dtype)
    shape = (64, 128)
    a = jnp.full(shape, 1.000001, jdt)
    b = jnp.full(shape, 0.9999, jdt)
    want = np.asarray(pl.pallas_call(
        partial(tool.kernel, dtype=jdt), out_shape=jax.ShapeDtypeStruct(shape, jdt),
        in_specs=[VMEM, VMEM], out_specs=VMEM, interpret=True)(a, b).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    ta = torch.full(shape, 1.000001).to(tdt)
    tb = torch.full(shape, 0.9999).to(tdt)
    fma_chain.launches = 0
    got = fma_chain(ta, tb, tool.N_ITER).float().numpy()
    assert fma_chain.launches == 0  # a CPU tensor takes the plain version
    np.testing.assert_array_equal(got, want)
    assert float(want[0, 0]) == (256.0 if dtype == "bfloat16" else np.float32(8224.2666))


def test_fma_chain_ref_random_slopes_match_tool_kernel():
    """Random slopes near 1 and offsets in [-1, 1], one element each, at the
    tool's 512 x 16 steps: exact against the tool's f32 kernel body."""
    tool = _load("bench_vpu_pallas")
    rng = np.random.default_rng(0)
    shape = (8, 128)
    a = rng.uniform(0.999, 1.001, shape).astype(np.float32)
    b = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    want = np.asarray(pl.pallas_call(
        partial(tool.kernel, dtype=jnp.float32),
        out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
        in_specs=[VMEM, VMEM], out_specs=VMEM, interpret=True)(jnp.asarray(a), jnp.asarray(b)))
    got = fma_chain_ref(torch.from_numpy(a), torch.from_numpy(b), tool.N_ITER).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,dynamic,chains", [
    ("k_static", False, 1), ("k_dynamic", True, 1),
    ("k_static_chains", False, 8), ("k_dynamic_chains", True, 8)])
def test_loadfma_ref_matches_tool_kernel(name, dynamic, chains):
    """Integer-valued inputs in [-8, 8]: every product and partial sum is an
    exact f32 integer, so any summation order gives the same value: exact.
    On ones, every output is 343."""
    tool = _load("bench_loadfma")
    rng = np.random.default_rng(1)
    kern = getattr(tool, name)
    call = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct((COLS, 16, 128), jnp.float32),
                          in_specs=[VMEM, VMEM], out_specs=VMEM, interpret=True)
    for buf, w in ((np.ones(SHAPE, np.float32), np.ones((1, 128), np.float32)),
                   (rng.integers(-8, 9, SHAPE).astype(np.float32),
                    rng.integers(-8, 9, (1, 128)).astype(np.float32))):
        want = np.asarray(call(jnp.asarray(buf), jnp.asarray(w)))
        got = loadfma(torch.from_numpy(buf), torch.from_numpy(w), dynamic, chains, reps=2)
        assert tuple(got.shape) == (2, COLS, 16, 128)
        np.testing.assert_array_equal(got[1].numpy(), want)
        np.testing.assert_array_equal(loadfma_ref(torch.from_numpy(buf), torch.from_numpy(w),
                                                  dynamic, chains).numpy(), want)
    assert (np.asarray(call(jnp.ones(SHAPE), jnp.ones((1, 128)))) == 343.0).all()
