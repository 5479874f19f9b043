"""The blend kernels' sub-tile cull, plain, on the CPU: the coverage mask's
shape and the pad entries past a tile's count, which must never pass, on
tests/test_torch_blend_cull.py's scenes and lists. Imports no JAX and
compiles nothing."""

import torch

from tests.test_torch_blend_cull import BX, SUB, lists  # noqa: F401  (a fixture)
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs_torch.raster import cuda_backend


def test_subtile_coverage_shape(lists):
    """One bit per (tile, sub-tile, entry); every sub-tile of a tile with a
    list keeps something, and the cull clears most pairs."""
    rec3, counts, _, cov = lists
    t, _, capk = rec3.shape
    assert cov.shape == (t, BX // SUB, capk) and cov.dtype == torch.bool
    assert int(counts.max()) > cuda_backend.CHUNK  # lists span several chunks
    live = int(counts.to(torch.int64).sum()) * (BX // SUB)
    share = int(cov.sum()) / live
    assert 0.0 < share < 0.9


def test_pad_entries_never_pass(lists):
    """Entries past a tile's count, and the never-hit pad records there,
    have no bit set."""
    rec3, counts, nty, cov = lists
    capk = rec3.shape[2]
    past = torch.arange(capk)[None, :] >= counts.to(torch.int64)[:, None]
    assert bool(past.any())
    assert not bool((cov & past[:, None, :]).any())
    # the pads' own coverage, with every entry counted live
    full = torch.full_like(counts, capk)
    pads_cov = cuda_backend.subtile_coverage(rec3, full, nty) & past[:, None, :]
    assert not bool(pads_cov.any())
