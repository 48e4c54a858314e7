"""The port's CPU tests share the machine's cores among pytest-xdist's
workers. Every ``tests/test_torch_*.py`` imports this module before torch
does any work, which, in an xdist worker, caps torch's intra-op threads at
``os.cpu_count() // PYTEST_XDIST_WORKER_COUNT`` (at least 1) and exports
the same count as ``OMP_NUM_THREADS`` to the processes the tests start.

Without the cap each worker's torch takes every core, the workers spin
against each other, and a test that takes 3 s alone takes minutes in the
suite. A process outside xdist keeps torch's own default.
"""

import os

import torch


def threads_per_worker(cpus: int | None, workers: str | None) -> int:
    """The cores of ``cpus`` one of ``workers`` xdist workers gets."""
    return max(1, (cpus or 1) // max(1, int(workers or 1)))


WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
THREADS = (threads_per_worker(os.cpu_count(), WORKERS) if WORKERS
           else torch.get_num_threads())
if WORKERS:
    torch.set_num_threads(THREADS)
    os.environ["OMP_NUM_THREADS"] = str(THREADS)


def test_torch_threads_are_this_workers_share():
    assert torch.get_num_threads() == THREADS
    if WORKERS:
        assert os.environ["OMP_NUM_THREADS"] == str(THREADS)


def test_threads_per_worker():
    assert threads_per_worker(8, "6") == 1
    assert threads_per_worker(8, "2") == 4
    assert threads_per_worker(8, "16") == 1
    assert threads_per_worker(None, "4") == 1
    assert threads_per_worker(8, None) == 8
