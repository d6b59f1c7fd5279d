import os

# Tests run on the single host CPU device; the 512-device dry-run flag is set
# ONLY inside repro.launch.dryrun (per its module docstring) and in
# subprocess-based tests — never globally here.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: slow tests (dry-run subprocesses, FL e2e)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips inside the test without one")


def pytest_addoption(parser):
    parser.addoption("--run-slow", action="store_true", default=False,
                     help="run slow tests (dry-run subprocesses, FL e2e)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--run-slow"):
        return
    skip = pytest.mark.skip(reason="slow; use --run-slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
