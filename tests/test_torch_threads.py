"""A share of the CPU's cores for torch's intra-op threads under xdist.

The port's heavy CPU test files (the plain kernels over large tiles:
the polygon-layer mirrors, the kNN folds, the SQL join, TubeSelect)
import `torch_cpu_share`, a module-scoped autouse fixture: while such a
file runs, torch's intra-op threads are the worker's share of the cores
(cores // xdist workers, at least 1), and the count before is restored
after the file. Without it every worker runs as many threads as there
are cores: under 6 workers on 8 cores four concurrent runs of
`test_torch_pip_layer_prune.py`'s NaN-edge mirrors took 742 s each,
against 12-13 s with 2 threads each, and that file held the tail of the
whole run. Run alone (no xdist), nothing changes.
"""

import os

import pytest
import torch


def cpu_share(cores: int, workers: int) -> int:
    """Threads for one of `workers` processes on `cores` cores."""
    return max(1, cores // max(1, workers))


@pytest.fixture(scope="module", autouse=True)
def torch_cpu_share():
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(min(before, cpu_share(os.cpu_count() or 1, workers)))
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("cores, workers, want", [
    (8, 6, 1), (8, 4, 2), (8, 1, 8), (2, 6, 1), (64, 6, 10), (1, 0, 1)])
def test_cpu_share(cores, workers, want):
    assert cpu_share(cores, workers) == want


def test_the_share_is_in_force():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert torch.get_num_threads() <= cpu_share(os.cpu_count() or 1, workers)
