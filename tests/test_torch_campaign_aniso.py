"""The accuracy campaign's aniso phantom (192x192x32, 24 thin tubes; about
20 s a package to place) equal in the port's tool and the JAX package's,
and the perslice scenario asking both generators for that same phantom.
The other scenarios are in ``tests/test_torch_campaign.py``."""

import numpy as np
import pytest
import torch

from skoots_tpu_torch.tools import accuracy_campaign as ac
from test_torch_campaign import assert_same_phantom, jax_campaign


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_aniso_phantom_equals_jaxs():
    """Image (with the EM-realism stack), labels and skeletons: equal; at
    least 20 tubes placed."""
    ours = ac._phantom("aniso", 999)
    assert_same_phantom(ours, jax_campaign()._phantom("aniso", 999))
    assert len(ours[2]) >= 20


def test_perslice_asks_for_the_aniso_phantom(monkeypatch):
    """``perslice`` scores the aniso scenario's volume: both tools call
    their tube generator with aniso's arguments (recorded, not rendered)."""
    import skoots_tpu.utils.synthetic as jax_synthetic
    import skoots_tpu_torch.utils.synthetic as synthetic

    for module, tool in ((synthetic, ac), (jax_synthetic, jax_campaign())):
        calls = []
        monkeypatch.setattr(module, "make_tubes", lambda **kw: calls.append(kw) or kw)
        assert tool._phantom_clean("perslice", 5) == tool._phantom_clean("aniso", 5)
        assert calls[0] == calls[1] == dict(shape=(192, 192, 32), n_tubes=24, radius=4,
                                            seed=5, min_separation=10.0)
    np.testing.assert_equal(ac.BARS, jax_campaign().BARS)
    assert ac.SCENARIOS == jax_campaign().SCENARIOS
    assert ac.MANUAL_KNOBS == jax_campaign().MANUAL_KNOBS
