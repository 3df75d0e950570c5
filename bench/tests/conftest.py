"""The benchmark's tests: the repository root and ``src`` on ``sys.path`` (``bench_small``), and
the ``cuda`` fixture."""

import pytest

import bench_small  # noqa: F401  (puts the repository root and src on sys.path)


@pytest.fixture
def cuda():
    """Skip unless a CUDA device is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
