"""One torch intra-op thread for the port's CPU tests.

The models are tiny, and under the suite's ``-n 6`` a thread per core in
every worker oversubscribes the CPU.  A test file imports the fixture
(``from torch_threads import one_thread``) and takes it for all its tests
(``pytestmark = pytest.mark.usefixtures("one_thread")``, set up before the
file's other module fixtures) or for the tests that need it.  Its scope is
the file: it holds from the first test that asks for it to the file's
end."""

import pytest
import torch


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
