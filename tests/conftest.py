"""Shared test configuration.

The core property tests require ``hypothesis`` (declared in
requirements-dev.txt and installed by CI). Containers that cannot
pip-install at test time fall back to ``tests/_stubs/hypothesis.py`` —
a minimal API-compatible stand-in that runs each property against
boundary examples plus seeded uniform randoms, so the suite still
collects and the properties still execute. Install the real package for
shrinking and coverage-guided generation.
"""
import os
import sys

try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "_stubs"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels of repro_torch); "
        "the test skips itself when torch.cuda.is_available() is false")
