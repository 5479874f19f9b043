"""Deterministic splat binning: depth compaction + prefix-sum selection
(port of tpu2dgs/raster/binning.py).

  1. `compact_visible`: one stable sort of the N splat depths (culled =
     +inf) yields a depth-ascending prefix of visible splat ids, ties
     broken by id. Downstream stages work in this compacted index space,
     so every per-row list comes out front-to-back by position.
  2. Selecting the first `cap` hits of a row is "indices of the first cap
     set bits" of a hit matrix: `first_k_hits` (a cumsum and a row-wise
     searchsorted), the building block of the select kernel's plain
     version and of the tiled backend's two levels, `select_coarse` (bins
     against the compacted splats) and `select_fine` (tiles against their
     bin's candidates).

Every output here is integer or a selection and equals the JAX package's
bit for bit; the tiled backend runs it as plain PyTorch on the caller's
device, as the JAX package runs it on XLA (no Pallas kernel reaches it).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu2dgs_torch.raster.preprocess import SplatScreen

# Bound on the bool hit matrix + int32 cumsum made per selection group:
# select_coarse takes its rows in groups so group_rows * M stays under this.
_MAX_ELEMENTS = 32 * 1024 * 1024


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


def searchsorted_rows(csum: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Row-wise first index where csum[r, i] >= target, for each target.

    csum: (R, M) nondecreasing int32 rows. targets: (C,) int32 >= 1.
    Returns (R, C) int64 in [0, M] (M where a row never reaches the
    target): the positions of the JAX package's binary search, found by
    torch.searchsorted (left side: the first i with target <= csum[r, i])."""
    r, c = csum.shape[0], targets.shape[0]
    return torch.searchsorted(csum.contiguous(), targets.expand(r, c).contiguous())


def first_k_hits(hit: torch.Tensor, cap: int):
    """Positions of the first `cap` True entries per row, in order.

    hit: (R, M) bool. Returns (pos (R, cap) int64 zero-filled,
    valid (R, cap) bool, counts (R,) int32 = total hits per row)."""
    csum = torch.cumsum(hit.to(torch.int32), dim=1, dtype=torch.int32)
    counts = csum[:, -1]
    targets = torch.arange(1, cap + 1, dtype=torch.int32, device=hit.device)
    pos = searchsorted_rows(csum, targets)
    valid = targets[None, :] <= counts[:, None]
    return torch.where(valid, pos, 0), valid, counts


def _overlaps(x0, x1, y0, y1, bx0, bx1, by0, by1):
    return (x0 <= bx1) & (x1 >= bx0) & (y0 <= by1) & (y1 >= by0)


def select_coarse(comp: Compacted, bx0, bx1, by0, by1, cap: int):
    """First-`cap` depth-ordered splats per coarse bin.

    bx0..by1: (NB,) f32 bin pixel rectangles (inclusive).
    Returns (pos (NB, cap) int64 compacted slots, valid, counts (NB,)).
    Rows are taken in groups to bound the (rows x K) hit matrix."""
    nb = bx0.shape[0]
    k = comp.x0.shape[0]
    group = max(1, min(nb, _MAX_ELEMENTS // max(k, 1)))
    outs = []
    for g in range(0, nb, group):
        sl = slice(g, g + group)
        hit = _overlaps(comp.x0[None], comp.x1[None], comp.y0[None], comp.y1[None],
                        bx0[sl, None], bx1[sl, None], by0[sl, None], by1[sl, None])
        outs.append(first_k_hits(hit, cap))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def select_fine(comp: Compacted, cand_pos, cand_valid, bin_of_tile,
                tx0, tx1, ty0, ty1, cap: int):
    """Refine coarse candidate lists to per-tile lists (order kept).

    cand_pos/cand_valid: (NB, B) coarse output. bin_of_tile: (T,) int.
    tx0..ty1: (T,) f32 tile rectangles. Returns (pos (T, cap) compacted
    slots, valid (T, cap), counts (T,))."""
    cx0 = torch.where(cand_valid, comp.x0[cand_pos], 1e9)
    cx1 = torch.where(cand_valid, comp.x1[cand_pos], -1e9)
    cy0 = torch.where(cand_valid, comp.y0[cand_pos], 1e9)
    cy1 = torch.where(cand_valid, comp.y1[cand_pos], -1e9)

    hit = _overlaps(
        cx0[bin_of_tile], cx1[bin_of_tile], cy0[bin_of_tile], cy1[bin_of_tile],
        tx0[:, None], tx1[:, None], ty0[:, None], ty1[:, None],
    )  # (T, B)
    sel, valid, counts = first_k_hits(hit, cap)
    pos = torch.gather(cand_pos[bin_of_tile], 1, sel)
    return torch.where(valid, pos, 0), valid, counts
