"""Fixtures shared by the port's kernel tests.  This module imports
neither JAX nor the tests' ``conftest.py``, so the card cases can import
it where JAX is not installed (``python -m pytest --noconftest``).  The
test files import it as a sibling module (pytest puts ``tests/`` on
``sys.path``), since ``tests`` itself may not import as a package there."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Run the plain versions on one CPU thread.  On a CPU host with
    AVX-512 and AMX, the first multi-threaded f32 matmul of a process that
    also runs JAX has returned one thread's 64-row block ~1e-4 off (3 of
    10 processes); on one thread the values are the same in every
    process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")
