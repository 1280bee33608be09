"""Shared fixtures of the benchmark's tests.

`card` marks a test that needs a CUDA card; the `card` fixture skips it
where there is none (decided when the test runs, never at import). Run the
card's tests on a machine with one:

    python3 -m pytest benchmark/tests -m card -q
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
