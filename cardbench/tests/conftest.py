"""The harness's own tests: on the CPU at smoke sizes, but for those
marked ``gpu``, which need a card (``python -m pytest cardbench/tests``
from the repository root; the repository's own suite does not collect
them)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
