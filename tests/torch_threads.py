"""torch's intra-op threads for the port's tests under pytest-xdist.

The workers share the machine's cores, and torch gives each of them one
intra-op thread a core: the workers' threads then outnumber the cores and
the port's small CPU ops spin on one another (a NAR resume test of 12 tiny
updates took 4.4 s with one thread and 90 s with torch's default, beside
five busy processes). Each `tests/test_torch_*.py` imports
`torch_threads_per_worker`, an autouse module fixture that runs its tests
on cpu_count / workers threads (one at `-n 6` on 8 cores) and gives the
JAX package's tests torch's default back.
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_threads_per_worker():
    """Yields torch's thread count before the module (its default), the
    count a test whose float32 sums were measured against JAX at it can set
    back: the count splits torch's reductions."""
    default = torch.get_num_threads()
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if os.environ.get("PYTEST_XDIST_WORKER") and workers:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))
    yield default
    torch.set_num_threads(default)
