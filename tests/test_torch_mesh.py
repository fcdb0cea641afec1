"""The port's device mesh (``skoots_tpu_torch/parallel``) against the JAX
package's on its 8 virtual CPU devices: ``make_mesh``'s shapes and
assertions, the split and replicate helpers, and the multi-process
bootstrap in one uninitialised process and over two spawned gloo
processes."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from skoots_tpu.parallel import distributed as jdist
from skoots_tpu.parallel import make_mesh as jax_make_mesh
from skoots_tpu_torch.parallel import (
    batch_sharding,
    make_mesh,
    replicated,
    spatial_sharding,
)
from skoots_tpu_torch.parallel import distributed as tdist

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite's parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _outcome(fn):
    try:
        return fn()
    except AssertionError as e:
        return f"AssertionError: {e}"


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("data", [-1, 1, 2])
@pytest.mark.parametrize("space", [1, 2, 4])
def test_make_mesh_matches_jax(data, space, n_dev):
    """The same shape, or the same assertion message, as JAX's over the
    same number of devices (JAX's are distinct, the port's may repeat)."""
    want = _outcome(lambda: jax_make_mesh(data, space, jax.devices()[:n_dev]))
    got = _outcome(lambda: make_mesh(data, space, ["cpu"] * n_dev))
    if isinstance(want, str):
        assert got == want
        return
    assert got.shape == dict(want.shape) and got.axis_names == want.axis_names
    assert [len(r) for r in got.devices] == [want.shape["space"]] * want.shape["data"]
    assert all(d == torch.device("cpu") for r in got.devices for d in r)


def test_make_mesh_orders_devices_row_major():
    devs = [torch.device("cpu")] * 4
    m = make_mesh(2, 2, devs)
    assert m.devices == [devs[:2], devs[2:]]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_split_and_replicate_helpers_match_jax_shardings():
    """Each piece equals the block JAX's NamedSharding puts on that
    device (``addressable_shards``), for the batch, spatial and replicated
    layouts."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8, 6, 5, 3)).astype(np.float32)
    jmesh = jax_make_mesh(2, 2, jax.devices()[:4])
    from skoots_tpu.parallel import batch_sharding as jbs
    from skoots_tpu.parallel import replicated as jrep
    from skoots_tpu.parallel import spatial_sharding as jss

    tmesh = make_mesh(2, 2, ["cpu"] * 4)
    t = torch.from_numpy(x)

    def shards(sharding):
        arr = jax.device_put(x, sharding)
        by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        return [[by_dev[d] for d in row] for row in np.asarray(jmesh.devices)]

    want = shards(jbs(jmesh, 5))
    got = batch_sharding(tmesh, t)
    assert len(got) == 2
    for row_want, piece in zip(want, got):
        for w in row_want:  # JAX's space replicas are equal: the port holds one
            np.testing.assert_array_equal(piece.numpy(), w)
    want = shards(jss(jmesh, 5, axis=1))
    got = spatial_sharding(tmesh, t, axis=1)
    for rw, rg in zip(want, got):
        for w, g in zip(rw, rg):
            np.testing.assert_array_equal(g.numpy(), w)
    want = shards(jrep(jmesh))
    got = replicated(tmesh, t)
    for rw, rg in zip(want, got):
        for w, g in zip(rw, rg):
            np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="not divisible"):
        batch_sharding(make_mesh(3, 1, ["cpu"] * 3), t)


def test_bootstrap_single_process_is_jax_like(caplog):
    """Uninitialised: rank 0 and a logged single-process mode, the identity
    broadcast, a no-op cleanup -- as JAX's functions on the CPU."""
    import logging

    with caplog.at_level(logging.INFO):
        assert tdist.setup_process() == 0
    assert any("single-process mode" in r.getMessage() for r in caplog.records)
    v = np.arange(5, dtype=np.int32)
    np.testing.assert_array_equal(tdist.broadcast_from_host0(v), v)
    np.testing.assert_array_equal(jdist.broadcast_from_host0(v), v)
    tdist.cleanup()
    assert not torch.distributed.is_initialized()
    p = tdist.find_free_port()
    assert 0 < p < 65536


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    for name in ("jax", "jaxlib", "flax", "skoots_tpu"):
        sys.modules[name] = None
    from skoots_tpu_torch.parallel import distributed as d
    rank, port = int(sys.argv[1]), int(sys.argv[2])
    got = d.setup_process(f"127.0.0.1:{port}", 2, rank)
    value = d.broadcast_from_host0(np.array([rank + 5, 7 * rank], np.int64))
    d.cleanup()
    print("RESULT", got, value.tolist(), flush=True)
""")


def test_bootstrap_over_two_gloo_processes():
    """Two processes rendezvous at a local tcp:// address: each gets its
    rank, and process 0's value reaches both."""
    port = tdist.find_free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(port)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=90)
            assert p.returncode == 0, err
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    results = [line.split(" ", 1)[1] for o in outs for line in o.splitlines()
               if line.startswith("RESULT")]
    assert results == ["0 [5, 0]", "1 [5, 0]"]
