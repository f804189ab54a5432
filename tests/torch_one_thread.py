"""The port's test files run smoke shapes on the CPU, where one intra-op
thread spends no time in the thread pool's barriers, which dominate when
the test workers share the host's cores. A test file takes the fixture
with ``from torch_one_thread import one_thread  # noqa: F401``."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
