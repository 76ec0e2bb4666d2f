import os
import sys

import pytest

# Tests run on the single real CPU device (the 512-device override is ONLY
# for repro.launch.dryrun, which sets XLA_FLAGS itself before jax import).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))

# The offline container cannot pip-install hypothesis; fall back to the
# deterministic seeded-example shim so property tests still collect and run.
try:
    import hypothesis  # noqa: F401
except ImportError:
    import _hypothesis_fallback
    _hypothesis_fallback.install()


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (long integration / dryrun sweeps)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running integration/dryrun test; skipped unless --runslow")
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow test: pass --runslow to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)
