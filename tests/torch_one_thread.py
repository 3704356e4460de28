"""A module-scoped autouse fixture that runs a test module's torch work on
one intra-op thread: the tests/tiny.py widths run fastest on one, and the
tier-1 run's workers share the host's cores. A test module takes it with

    from torch_one_thread import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
