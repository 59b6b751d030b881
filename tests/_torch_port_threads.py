"""One torch thread for a port test file.

A port test file runs many small tensor ops.  Under the suite's xdist
workers, torch's thread pool on every core spins against the workers
beside it and such a file runs many times slower than alone; on one
thread it runs about as fast as on all cores alone.  Import the fixture
into the test module to use it:

    from _torch_port_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The module's torch ops on one thread; the count is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
