"""The one-thread fixture of the port's CPU test files.

Under pytest-xdist every worker process has its own torch and BLAS thread
pools; six workers on eight cores oversubscribe the cores, and small
parallel operations then run many times slower than alone (threads spinning
on descheduled ones). A test file of the port imports ``one_thread_each``,
which then runs around the whole file: one intra-op thread for torch and for
numpy's BLAS while its tests run. The port's summation order does not depend
on the thread count in the tests that compare bit for bit: both sides of
such a comparison run in the same process under the same setting.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_info, threadpool_limits


@pytest.fixture(autouse=True, scope="module")
def one_thread_each():
    """One intra-op thread for torch and numpy's BLAS while a module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


def test_one_thread_each_limits_torch_and_blas():
    assert torch.get_num_threads() == 1
    assert all(p["num_threads"] == 1 for p in threadpool_info())
    a = np.random.default_rng(0).standard_normal((64, 64))
    np.testing.assert_allclose(a @ np.linalg.inv(a), np.eye(64), atol=1e-8)
