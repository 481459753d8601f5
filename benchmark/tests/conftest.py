"""Tests of the benchmark harness. They import neither JAX nor the JAX
package; a test that needs a CUDA card is marked `cuda` and decides
inside itself whether one is present."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")
