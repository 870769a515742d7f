import os
import sys

# tests see 1 CPU device (the dry-run sets its own XLA_FLAGS in-process);
# subprocess-based distributed tests set the flag in their own env.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-subprocess chaos scenarios (run in CI's chaos job)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the PyTorch port's Hopper kernels); "
        "skips without one")
