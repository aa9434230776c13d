"""An autouse fixture for the port's CPU tests: torch on one thread.

Under the suite's 6 workers on a few cores, each process's default
intra-op thread pool contends with the others' and small torch ops stall
(a CLI test took ~60x its time alone).  A test module imports
``one_torch_thread`` to use it; module-scoped, it comes before the
module's other fixtures."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
