"""Deterministic splat binning: depth compaction + prefix-sum selection
(port of tpu2dgs/raster/binning.py).

  1. `compact_visible`: one stable sort of the N splat depths (culled =
     +inf) yields a depth-ascending prefix of visible splat ids, ties
     broken by id. Downstream stages work in this compacted index space,
     so every per-row list comes out front-to-back by position.
  2. Selecting the first `cap` hits of a row is "indices of the first cap
     set bits" of a hit matrix: `first_k_hits` (a cumsum and a row-wise
     searchsorted), the building block of the select kernel's plain
     version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu2dgs_torch.raster.preprocess import SplatScreen


class Compacted(NamedTuple):
    """Depth-ordered visible prefix of the splat array."""

    perm: torch.Tensor         # (K,) int32 splat id at compacted slot
    valid: torch.Tensor        # (K,) bool — slot < num_visible
    num_visible: torch.Tensor  # () int32
    # Screen AABBs in compacted order (never-hit boxes when invalid):
    x0: torch.Tensor
    x1: torch.Tensor
    y0: torch.Tensor
    y1: torch.Tensor
    depth: torch.Tensor        # (K,) sorted view depth (+inf past visible)


def pack_interval(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Pack a screen [lo, hi] f32 interval into one int64 as a pair of
    inward-rounded integer pixel bounds (16 bits each, offset by 32768).

    Every binning rectangle has integer pixel corners, so for integer b:
    lo <= b <=> ceil(lo) <= b and hi >= b <=> floor(hi) >= b. Inward
    rounding keeps the hit sets exact. Bounds clip to +-32767: every
    rectangle lives in [0, dim], and empty lo > hi intervals (the +-1e9
    culled markers) stay empty."""
    loq = torch.clamp(torch.ceil(lo), -32767.0, 32767.0).to(torch.int64)
    hiq = torch.clamp(torch.floor(hi), -32767.0, 32767.0).to(torch.int64)
    return ((loq + 32768) << 16) | (hiq + 32768)


def unpack_interval(p: torch.Tensor):
    """Inverse of pack_interval: int64 -> (lo, hi) f32 (integer-valued)."""
    lo = (p >> 16) - 32768
    hi = (p & 0xFFFF) - 32768
    return lo.to(torch.float32), hi.to(torch.float32)


def compact_visible(splats: SplatScreen, k: int) -> Compacted:
    """Stable depth sort -> first-k visible prefix (ties broken by id)."""
    depth = splats.depth.detach()  # +inf where culled
    c = splats.box_center.detach()
    e = splats.box_half.detach()
    px = pack_interval(c[:, 0] - e[:, 0], c[:, 0] + e[:, 0])
    py = pack_interval(c[:, 1] - e[:, 1], c[:, 1] + e[:, 1])
    sdepth, order = torch.sort(depth, stable=True)
    order = order[:k]
    perm = order.to(torch.int32)
    num_visible = torch.sum(splats.visible, dtype=torch.int32)
    valid = torch.arange(k, dtype=torch.int32, device=depth.device) < num_visible

    lox, hix = unpack_interval(px[order])
    loy, hiy = unpack_interval(py[order])
    x0 = torch.where(valid, lox, 1e9)
    x1 = torch.where(valid, hix, -1e9)
    y0 = torch.where(valid, loy, 1e9)
    y1 = torch.where(valid, hiy, -1e9)
    dep = torch.where(valid, sdepth[:k], torch.inf)
    return Compacted(perm, valid, num_visible, x0, x1, y0, y1, dep)


def first_k_hits(hit: torch.Tensor, cap: int):
    """Positions of the first `cap` True entries per row, in order.

    hit: (R, M) bool. Returns (pos (R, cap) int64 zero-filled,
    valid (R, cap) bool, counts (R,) int32 = total hits per row)."""
    csum = torch.cumsum(hit.to(torch.int32), dim=1, dtype=torch.int32)
    counts = csum[:, -1]
    targets = torch.arange(1, cap + 1, dtype=torch.int32, device=hit.device)
    pos = torch.searchsorted(csum, targets.expand(csum.shape[0], cap).contiguous())
    valid = targets[None, :] <= counts[:, None]
    return torch.where(valid, pos, 0), valid, counts
