"""The port's test modules run torch on one intra-op thread.

Their CPU work is many small products: one thread is fastest, and stays
fast when other test processes share the cores (each xdist worker's torch
would otherwise start a thread for every core).  A module takes the
fixture with ``from _one_thread import one_thread  # noqa: F401``.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
