"""Tile-binned rasterizer in plain PyTorch (port of tpu2dgs/raster/tiled.py).

  1. Depth compaction: one stable sort of the N splat depths (culled =
     +inf) gives a depth-ordered visible prefix (binning.compact_visible).
  2. Coarse binning: the screen is cut into bins of coarse_tiles x
     coarse_tiles fine tiles; each bin keeps its front-most `bin_capacity`
     overlapping splats by position (binning.select_coarse).
  3. Fine binning: each tile_px x tile_px tile refines its bin's list to
     `tile_capacity` entries the same way (binning.select_fine). Position in
     the compacted order is front-to-back depth order, ties broken by id.
  4. Blending: every tile walks its list `chunk` splats a step with the
     shared compositing math (raster/blend.py), all tiles at once as a
     batch dimension.

No kernel: the JAX module reaches no pl.pallas_call, so this is plain
PyTorch under autograd on the caller's device, as the JAX backend is XLA.
Each step runs under torch.utils.checkpoint when autograd records: a
step's (T, chunk, P) temporaries (about 25 of them, 82 MB each for an
800x800 image) are recomputed in the backward pass, and only the 13-float
pixel state between steps is kept.

`rasterize_rows` renders a strip of tile rows starting at a tile-row
offset, the unit of multi-device rendering. Overflow (a tile touching more
than `tile_capacity` splats) drops the farthest splats; the `_aux_*`
counters report it, in the convention the Trainer heals from.
"""

from __future__ import annotations

import torch

from tpu2dgs_torch.raster import binning
from tpu2dgs_torch.raster import blend
from tpu2dgs_torch.raster.preprocess import SplatScreen


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def bin_square(splats: SplatScreen, settings, nty_local: int, tile_row_offset: int,
               bin_cap: int, tile_cap: int, k_vis: int):
    """Two-level square-tile binning through binning.py's compaction.

    Returns (comp, tile_ids (T, cap) splat ids, tile_valid, counts (T,) raw
    overlap counts, bin_counts (NB,))."""
    w = settings.width
    tpx = settings.tile_px
    cbt = settings.coarse_tiles
    ntx = _cdiv(w, tpx)
    nbx, nby = _cdiv(ntx, cbt), _cdiv(nty_local, cbt)
    dev = splats.tmat.device

    comp = binning.compact_visible(splats, k_vis)

    nb = nby * nbx
    bin_px = tpx * cbt
    bins = torch.arange(nb, dtype=torch.float32, device=dev)
    bix = bins % nbx
    biy = torch.div(bins, nbx, rounding_mode="floor") + float(tile_row_offset) / cbt
    bx0 = bix * bin_px
    bx1 = bx0 + (bin_px - 1)
    by0 = biy * bin_px
    by1 = by0 + (bin_px - 1)
    cand_pos, cand_valid, bin_counts = binning.select_coarse(
        comp, bx0, bx1, by0, by1, bin_cap)

    t = nty_local * ntx
    tiles = torch.arange(t, dtype=torch.int32, device=dev)
    tix = tiles % ntx
    tiy_local = torch.div(tiles, ntx, rounding_mode="floor")
    bin_of_tile = (torch.div(tiy_local, cbt, rounding_mode="floor") * nbx
                   + torch.div(tix, cbt, rounding_mode="floor")).long()
    tx0 = (tix * tpx).to(torch.float32)
    tx1 = tx0 + (tpx - 1)
    ty0 = ((tiy_local + tile_row_offset) * tpx).to(torch.float32)
    ty1 = ty0 + (tpx - 1)
    tile_pos, tile_valid, counts = binning.select_fine(
        comp, cand_pos, cand_valid, bin_of_tile, tx0, tx1, ty0, ty1, tile_cap)
    tile_ids = comp.perm[tile_pos]
    return comp, tile_ids, tile_valid, counts, bin_counts


def rasterize_rows(splats: SplatScreen, settings, bg_color: torch.Tensor,
                   tile_row_offset: int, nty_local: int, return_aux: bool = False):
    """Rasterize a strip of `nty_local` tile rows starting at fine-tile row
    `tile_row_offset` (a multiple of coarse_tiles). Returns (strip
    (nty_local*tpx, W', 3), allmap dict) with W' = ntx*tpx (the caller
    crops to the true width)."""
    w = settings.width
    tpx = settings.tile_px
    n = splats.tmat.shape[0]
    dev = splats.tmat.device

    ntx = _cdiv(w, tpx)
    t = ntx * nty_local
    p = tpx * tpx

    bin_cap = min(settings.bin_capacity, _pow2_at_least(n))
    tile_cap = min(settings.tile_capacity, bin_cap)
    k_vis = min(settings.vis_capacity or n, n)

    comp, tile_ids, tile_valid, counts, bin_counts = bin_square(
        splats, settings, nty_local, tile_row_offset, bin_cap, tile_cap, k_vis)

    # Per-tile global pixel coordinates.
    tiles = torch.arange(t, device=dev)
    tix = tiles % ntx
    tiy = torch.div(tiles, ntx, rounding_mode="floor") + tile_row_offset
    local = torch.arange(tpx, dtype=torch.float32, device=dev)
    ly = local.repeat_interleave(tpx)  # (P,)
    lx = local.repeat(tpx)
    px = tix[:, None].to(torch.float32) * tpx + lx[None, :]  # (T, P)
    py = tiy[:, None].to(torch.float32) * tpx + ly[None, :]

    chunk = settings.chunk
    steps = _cdiv(tile_cap, chunk)
    pad = steps * chunk - tile_cap
    if pad:
        tile_ids = torch.cat([tile_ids, tile_ids.new_zeros((t, pad))], dim=1)
        tile_valid = torch.cat([tile_valid, tile_valid.new_zeros((t, pad))], dim=1)
    ids_steps = tile_ids.reshape(t, steps, chunk).unbind(1)
    valid_steps = tile_valid.reshape(t, steps, chunk).unbind(1)

    def body(state, ids, ok):  # ids, ok: (T, chunk)
        alpha, depth, contrib = blend.splat_pixel_response(
            splats.tmat[ids], splats.filter_center[ids], splats.opacity[ids], px, py)
        contrib = contrib & ok[:, :, None]  # (T, chunk, P)
        return blend.blend_chunk(
            state, alpha, depth, contrib, splats.color[ids], splats.normal[ids])

    state = blend.init_state((t, p), dtype=splats.tmat.dtype, device=dev)
    state = blend.scan_chunks(body, state, zip(ids_steps, valid_steps))
    color, maps = blend.finalize(state, bg_color)

    def untile(a):
        a = a.reshape(nty_local, ntx, tpx, tpx, *a.shape[2:])
        return a.transpose(1, 2).reshape(nty_local * tpx, ntx * tpx, *a.shape[4:])

    image = untile(color)
    allmap = {k: untile(v) for k, v in maps.items()}
    # Capacity counters in the cuda backend's _aux_* convention, so the
    # Trainer's adaptive cap growth reads them from either backend.
    f32 = torch.float32
    allmap["_aux_tile_overflow_frac"] = torch.mean((counts > tile_cap).to(f32))
    allmap["_aux_bin_overflow_frac"] = torch.mean((bin_counts > bin_cap).to(f32))
    allmap["_aux_tile_count_max"] = torch.amax(counts).to(f32)
    allmap["_aux_bin_count_max"] = torch.amax(bin_counts).to(f32)
    # Blended work (capacity-clamped tile entries): the load-balance signal
    # of tile-row sharding.
    allmap["_aux_strip_work"] = torch.sum(torch.clamp(counts, max=tile_cap)).to(f32)
    if not return_aux:
        return image, allmap
    aux = {
        "tile_count_max": torch.amax(counts),
        "tile_overflow": torch.sum(counts > tile_cap),
        "bin_count_max": torch.amax(bin_counts),
        "bin_overflow": torch.sum(bin_counts > bin_cap),
    }
    return image, allmap, aux


def rasterize_tiled(splats: SplatScreen, settings, bg_color: torch.Tensor,
                    return_aux: bool = False):
    """Returns (image (H,W,3), allmap dict) [, aux dict]."""
    h, w = settings.height, settings.width
    nty = _cdiv(h, settings.tile_px)
    out = rasterize_rows(splats, settings, bg_color, 0, nty, return_aux=return_aux)
    image = out[0][:h, :w]
    allmap = {k: v if k.startswith("_aux_") else v[:h, :w] for k, v in out[1].items()}
    if return_aux:
        return image, allmap, out[2]
    return image, allmap
