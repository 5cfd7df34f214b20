import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

# Shared fake-device subprocess helper (multi-device tests must not
# pollute this process's jax device count — smoke tests see 1 device —
# hence subprocesses; benches and CLI smokes use the same util).
from repro.common.subproc import run_subprocess  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "chaos: fault-injected serving degradation tests (DESIGN.md §12); "
        "run in isolation with `pytest -m chaos`")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device; skips where there is none (README.md)")


@pytest.fixture
def subproc():
    return run_subprocess
