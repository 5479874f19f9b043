"""The fixture every CPU test file of tpu2dgs_torch imports: it holds no
tests, and imports no JAX, so that the files that import none (the plain
models of the kernels, which tests/test_torch_cuda.py reads on the card)
can use it too.

`one_torch_thread` runs a file's tests with PyTorch on one intra-op thread.
In a process that also runs JAX, about half the processes got an intra-op
worker thread whose torch.exp was off by up to 1.5e-4 relative on its
share of a tensor (on an 8-core x86 CPU with AVX-512; one thread never
showed it), more than the parity tolerances allow. And the test runner
gives each of its workers a file at a time: PyTorch's default of one
thread a core would let each file take every core from the files beside
it.

A file uses it with
`from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)`;
tests/test_torch_select_chunks.py, which tests/test_torch_cuda.py reads on
the card without the conftest, imports it as `test_torch_threads`, since
there `tests` may name another installed package.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
