"""One torch intra-op thread for the port's CPU tests.

Tier-1 runs the suite as six xdist workers on an eight-core host. torch's
default pool of one OpenMP thread per core makes each op of the port's
tiny models fork and join eight threads, which spin against the other
workers' processes: on such a host ``tests/test_torch_builtin.py`` took
45.8 s alone and 532 s inside a full run with eight threads, and 15.3 s
alone with one. Each test module of the port imports this fixture
(``from torch_threads import one_torch_thread``), which gives torch one
thread while the module runs and restores the count after it.
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
