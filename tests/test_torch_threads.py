"""The fixtures every CPU test file of tpu2dgs_torch imports: it holds no
tests, and imports no JAX at import time, so that the files that import
none (the plain models of the kernels, which tests/test_torch_cuda.py
reads on the card) can use it too.

`one_torch_thread` runs a file's tests with PyTorch on one intra-op thread.
In a process that also runs JAX, about half the processes got an intra-op
worker thread whose torch.exp was off by up to 1.5e-4 relative on its
share of a tensor (on an 8-core x86 CPU with AVX-512; one thread never
showed it), more than the parity tolerances allow. And the test runner
gives each of its workers a file at a time: PyTorch's default of one
thread a core would let each file take every core from the files beside
it.

`jax_compile_cache` gives the JAX programs a file compiles a persistent
compilation cache shared by the files of one test run: a program that
another file (in another worker process) or an earlier test has compiled
at the same shapes is loaded instead of compiled again. The directory is
the run's own, never a user's cache and never one an earlier run left, so
every run compiles each program it tests at least once. On teardown the
three JAX settings it changes are back to their earlier values and the
cache is reset, so the JAX package's files a worker runs next see the
configuration they see without it. Every file that compiles JAX uses it.

A file uses them with
`from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)`
and, where it compiles JAX, `jax_compile_cache` on the same line;
the JAX-free tests/test_torch_select_chunks*.py, which run on the card
without the conftest, import it as `test_torch_threads`, since there
`tests` may name another installed package.
"""

import contextlib
import os

import pytest
import torch

# the settings jax_compile_cache changes: its directory, the compile time
# past which a program is written (1 s by default), and the entry size the
# cache sets for itself when it starts
CACHE_SETTINGS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
                  "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_cache_dir(tmp_path_factory):
    """The run's cache directory: under xdist, beside the workers' own
    temporary directories and named by the run's id, so every worker of
    the run shares it; else in this session's fresh temporary directory."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    path = base.parent / f"jax-cache-{run}" if run else base / "jax-cache"
    path.mkdir(exist_ok=True)
    return path


@contextlib.contextmanager
def compile_cache(path):
    """JAX's persistent compilation cache at `path` for every program
    compiled inside, however short its compile; on exit the settings of
    CACHE_SETTINGS are back to what they were and the cache is reset."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache

    before = {name: getattr(jax.config, name) for name in CACHE_SETTINGS}
    compilation_cache.reset_cache()
    jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    try:
        yield path
    finally:
        compilation_cache.reset_cache()
        for name, value in before.items():
            jax.config.update(name, value)


@pytest.fixture(scope="module", autouse=True)
def jax_compile_cache(tmp_path_factory):
    with compile_cache(run_cache_dir(tmp_path_factory)) as path:
        yield path
