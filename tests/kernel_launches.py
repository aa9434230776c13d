"""A fixture for the port's tests that count kernel launches.

Every hand-written kernel goes on the stream through one call,
``mpsnerf_torch.cuda_build.launch``; ``launches`` wraps it from outside
for the test's duration.  On a machine with a CUDA card each launch is
made and counted by its C symbol; without one a launch fails the test (a
CPU tensor must never reach a kernel).  A test module imports
``launches`` to use it."""

import collections

import pytest
import torch

from mpsnerf_torch import cuda_build


@pytest.fixture
def launches(monkeypatch):
    """The launches made in the test: a Counter, symbol -> launches."""
    counts = collections.Counter()
    launch = cuda_build.launch

    def counted(name, symbol, *args):
        if not torch.cuda.is_available():
            pytest.fail(f"{symbol} launched without a CUDA card")
        launch(name, symbol, *args)
        counts[symbol] += 1

    monkeypatch.setattr(cuda_build, "launch", counted)
    return counts
