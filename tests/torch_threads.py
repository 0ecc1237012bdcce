"""One torch intra-op thread for a port test module (import the fixture
into the module: ``from torch_threads import one_torch_thread``).

The port's CPU tests run many small ops. Under the tier-1 command's six
test workers on an 8-core machine, torch's default of one intra-op thread
a core oversubscribes the cores and such loops slow down by an order of
magnitude (``tests/test_torch_system.py``: 19 s alone with 8 threads, 18 s
with one, 226 s in the parallel run with 8); one thread a worker keeps
each module near its time alone. The count is restored after the module.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
