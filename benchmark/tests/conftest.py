"""Fixtures of the benchmark's tests.  A test that needs the card takes
``cuda_device``, which decides there, not at import, whether a card is
present, and skips without one (the repository's ``gpu`` marker)."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the tiny runs gain nothing from more threads, and several test workers
# and rank processes share the CPU
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)
