import os
import sys

# tests see ONE cpu device (the dry-run forces 512 only in its own process)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def _fresh_measure_state():
    """Per-test isolation for absorption's process-level measurement state:
    the per-series floor_time warning dedup and the synthetic clock's
    drift counter / hang latch."""
    import importlib

    # note: ``repro.core.absorption`` the *attribute* is the absorption()
    # function (re-exported by the package); go through importlib to get
    # the module itself
    absorption_mod = importlib.import_module("repro.core.absorption")
    absorption_mod.reset_floor_warnings()
    absorption_mod.reset_synth_state()
    yield
    absorption_mod.release_synth_hang()  # never leave a parked thread behind


class _HypothesisStub:
    """Stands in for ``hypothesis`` when it isn't installed: ``@given`` marks
    the test skipped (instead of the import crashing collection), ``settings``
    is identity, and strategies return inert placeholders. Non-property tests
    in the same module keep running."""

    def given(self, *a, **k):
        return pytest.mark.skip(reason="hypothesis not installed "
                                       "(see requirements-dev.txt)")

    def settings(self, *a, **k):
        return lambda f: f

    def __getattr__(self, name):
        return lambda *a, **k: None


hypothesis_stub = _HypothesisStub()
strategies_stub = _HypothesisStub()


def assert_close(a, b, rtol=2e-3, atol=2e-3, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)
