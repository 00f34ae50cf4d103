import pytest
import torch

pytest.register_assert_rewrite("port_bench.tests.checks")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips without one (decided inside the test)")


@pytest.fixture
def card():
    """Skip unless a CUDA device is present: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python3 -m pytest port_bench/tests -m card)")
    return torch.device("cuda")
