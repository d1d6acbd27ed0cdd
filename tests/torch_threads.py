"""A module-scoped autouse fixture for the port's heavier CPU test files:
one intra-op torch thread while the module runs. The tier-1 command runs
six pytest workers on a shared CPU; the small tensor programs of these
tests then run many times faster on one thread than on a full pool that
contends with the other workers. Import it into a test module:

    from torch_threads import one_intra_op_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
