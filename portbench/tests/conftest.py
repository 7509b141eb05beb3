"""The benchmark's CPU tests: ``python -m pytest portbench/tests -q`` from
the root of the checkout.  The repository root goes on ``sys.path`` (the
harness imports as ``portbench``), and torch keeps to a few CPU threads."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def few_threads():
    keep = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(keep)
