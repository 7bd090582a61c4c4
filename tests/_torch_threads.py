"""Thread caps of the port's test processes.

The suite runs several pytest workers on the machine's cores. By
default torch takes one intra-op thread a core in every worker, and
every JAX reference process or gloo rank a test starts takes a pool of
its own, so together they oversubscribe the cores and a test that times
itself (the invariant scan's budget) sees the contention.
Importing this module caps torch in a pytest-xdist worker at its share
of the cores; ``capped_env`` is the environment of every process a test
starts: one OpenMP thread, and XLA's CPU backend on one thread.
"""
from __future__ import annotations

import os

import torch

#: XLA's CPU backend on the calling thread alone (no Eigen pool)
XLA_ONE_THREAD = "--xla_cpu_multi_thread_eigen=false " \
                 "intra_op_parallelism_threads=1"


def worker_threads() -> int:
    """The cores of the machine over the pytest-xdist workers (at least
    one); all of them outside xdist."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // workers)


def capped_env(xla_flags: str = "", **extra) -> dict:
    """``os.environ`` with ``extra`` set, one OpenMP thread, and
    ``xla_flags`` (e.g. a host device count) beside XLA's single-thread
    flags."""
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    env["XLA_FLAGS"] = f"{xla_flags} {XLA_ONE_THREAD}".strip()
    return env


if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(worker_threads())
