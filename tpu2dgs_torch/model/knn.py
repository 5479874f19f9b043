"""Exact 3-nearest-neighbor mean squared distance (port of
tpu2dgs/model/knn.py).

Used once at init to set initial splat scales: an exact blocked O(N^2)
sweep with a streaming top-4 keeps memory at O(row_block * col_chunk) and
runs on whatever device the points are on.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def mean_dist2_to_3nn(points: torch.Tensor, row_block: int = 1024,
                      col_chunk: int = 8192) -> torch.Tensor:
    """(N,3) float32 -> (N,) mean squared distance to the 3 nearest
    neighbors, the point itself excluded; callers clamp the result. A
    cloud of fewer than 4 points gives inf."""
    n = points.shape[0]
    k = 4  # keep 4 smallest: self (0) + 3 neighbors
    out = []
    for r0 in range(0, n, row_block):
        rblk = points[r0:r0 + row_block]
        best = torch.full((rblk.shape[0], k), torch.inf, dtype=points.dtype,
                          device=points.device)
        for c0 in range(0, n, col_chunk):
            cchunk = points[c0:c0 + col_chunk]
            d2 = torch.sum((rblk[:, None, :] - cchunk[None, :, :]) ** 2, dim=-1)
            merged = torch.cat([best, d2], dim=1)
            best = torch.topk(merged, k, dim=1, largest=False, sorted=True).values
        # best is ascending; column 0 is the self-distance (0).
        out.append(torch.mean(best[:, 1:], dim=1))
    return torch.cat(out) if out else points.new_zeros((0,))
