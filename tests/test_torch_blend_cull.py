"""The blend kernels' sub-tile cull, plain, on the CPU.

Both blend kernels walk, per 16x16 sub-tile and per 16x4 block of a warp,
only the list entries whose exact coverage reaches it
(`cuda_backend.subtile_coverage` is the plain version of that mask). That
is only right if the cull is a superset of the per-pixel hit test: every
(record, pixel) pair that passes `_splat_response`'s hit test must lie in a
block whose bit is set, and pad entries past a tile's count must never
pass. Small seeded bench-like
and shell-like scenes, lists binned by the port's plain levels; the
mask's shape and the pad entries are tests/test_torch_blend_cull_mask.py's.
Imports no JAX and compiles nothing.
"""

import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs_torch.eval import synthetic
from tpu2dgs_torch.raster import binning, cuda_backend, preprocess

BY, BX, SUB = cuda_backend.BY, cuda_backend.BX, cuda_backend.SUB
SCENES = {
    # a depth pileup of random anisotropic surfels: lists reach the capacity
    "bench": lambda: synthetic.make_bench_scene(256, 96, 3000, seed=3, device="cpu"),
    # a trained-like shell: background tiles, long thin splats at the rim
    "shell": lambda: synthetic.make_shell_scene(256, 96, 3000, seed=5, device="cpu"),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def lists(request):
    """(rec3, counts, nty, cov) of one scene at capacities its lists reach."""
    cam, scene = SCENES[request.param]()
    w, h = 256, 96
    splats = preprocess.preprocess(*scene, cam, w, h, 3)
    n = scene[0].shape[0]
    comp = binning.compact_visible(splats, n)
    rec = cuda_backend.pack_records(splats)
    nbx, nty = -(-w // BX), -(-h // BY)
    rec3, raw, _, _ = cuda_backend._bin_records(
        comp.x0, comp.x1, comp.y0, comp.y1, comp.num_visible, rec, nbx, nty, 1024, 384,
        ids=comp.perm, plain=True)
    counts = torch.clamp(raw, max=rec3.shape[2]).to(torch.int32)
    cov = cuda_backend.subtile_coverage(rec3, counts, nty)
    return rec3, counts, nty, cov


@pytest.mark.parametrize("rows", [BY, 4])
def test_cull_keeps_every_hit(lists, rows):
    """Every (record, pixel) pair that passes the blend's hit test lies in
    a block whose bit is set, for the 16x16 sub-tiles and for the 16x4
    blocks the kernels' warps cull: the kernels skip no pair that could
    blend."""
    rec3, counts, nty, _ = lists
    t = rec3.shape[0]
    cov = cuda_backend.subtile_coverage(rec3, counts, nty, rows)
    per_col = BY // rows
    assert cov.shape == (t, BX // SUB * per_col, rec3.shape[2])
    px, py = cuda_backend._tile_planes(t, nty, rec3.device)
    px, py = px[:, None], py[:, None]  # (T, 1, BY, BX) against 64 entries at once
    # block of every pixel of a tile: (BY, BX) indices into cov's dim 1
    block = (torch.arange(BX) // SUB)[None, :] * per_col + (torch.arange(BY) // rows)[:, None]
    n_hits = 0
    for j0 in range(0, int(counts.max()), cuda_backend.CHUNK):
        j = torch.arange(j0, j0 + cuda_backend.CHUNK)
        r = [rec3[:, k, j0:j0 + cuda_backend.CHUNK, None, None] for k in range(21)]
        hit = cuda_backend._splat_response(r, px, py)[2]  # (T, 64, BY, BX)
        hit = hit & (j[None, :] < counts[:, None])[:, :, None, None]
        kept = cov[:, :, j0:j0 + cuda_backend.CHUNK][:, block].permute(0, 3, 1, 2)
        missed = hit & ~kept
        assert not bool(missed.any()), (
            f"entries {j0}+: {int(missed.sum())} hitting pixels in culled blocks")
        n_hits += int(hit.sum())
    assert n_hits > 0
