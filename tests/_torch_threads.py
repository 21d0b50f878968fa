"""A module-scoped autouse fixture for the port's test files: one torch
intra-op thread while the module runs, restored after. The suite runs
with several test workers (pytest-xdist) on one host; a torch op on the
CPU otherwise takes a thread a core in every worker, and the JAX files
that share the host slow down. A module takes it with::

    from _torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
