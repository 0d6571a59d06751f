import os
import sys

# tests run on the single real CPU device (the 512-device override is ONLY
# for launch/dryrun.py, which sets XLA_FLAGS before importing jax)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (skips without one); run on the card with "
        "`python -m pytest -m gpu tests/test_torch_gpu.py`",
    )
