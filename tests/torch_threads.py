"""The torch test modules' shared fixture (not a test module: pytest does
not collect it).  Each tests/test_torch_*.py imports it, which makes it
autouse there:

    from torch_threads import one_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op torch thread while a test runs: the tests' ops are
    small, and the suite runs in parallel workers, where a pool of threads
    per op (torch's default is one a core) costs more than the op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
