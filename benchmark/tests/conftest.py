"""Shared fixtures of the benchmark's tests.  Whether there is a CUDA card
is decided inside fixtures, never while a module is imported."""

import pytest

TINY = dict(width=48, height=27, max_iterations=150)


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture
def card_absent():
    """Skips the test where a CUDA card is present."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
