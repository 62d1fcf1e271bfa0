import pytest


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The small cells are many small ops, which a thread pool per worker
    only slows when the suite's workers share the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
