"""The benchmark's own tests: `python -m pytest portbench/tests -q`.

They run on the CPU: the program's kernels as their plain PyTorch
twins, at sizes a test can hold. Tests marked `card` need a CUDA card
and skip without one; on the card machine run them with
`python -m pytest portbench/tests -q -m card`.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
