"""pytest settings of the benchmark's own tests (benchmark/tests):
`python -m pytest benchmark/tests -q`. Tests marked `card` need a CUDA
device; the `cuda_device` fixture skips them where there is none, so the
decision is made when a test runs, never while a module is imported."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (runs on the H100)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here; run on the H100")
    return torch.device("cuda", 0)
