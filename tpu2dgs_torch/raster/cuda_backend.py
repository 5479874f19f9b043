"""Fused CUDA rasterizer, forward half (port of
tpu2dgs/raster/pallas_backend.py).

The pipeline of the JAX backend, kept contract for contract:

  * `pack_records`: one 24-float record per splat (layout below).
  * `_bin_records`: three select levels (screen columns -> coarse bins ->
    16x128-pixel tiles), carrying full records through the compaction, so
    the last level's output rec3 (T, 24, capk) is the per-tile list the
    blend reads. Column-major tiles: t = tix * nty + tiy.
  * `blend_tiles`: the forward blend kernel (csrc/blend_forward.cu,
    replacing the TPU `_fwd_kernel`) on a CUDA tensor, its plain PyTorch
    version `blend_tiles_plain` on a CPU tensor.
  * `blend_binned`: untile into image planes plus the `_aux_*` counters.

Capacities round exactly as the JAX backend rounds them (`_round128`,
`_round_group` with GROUP = 256), so per-tile lists, counts and overflow
counters agree even when capacities overflow. This slice renders only:
there is no backward kernel yet, and api.render runs under torch.no_grad().

Record layout (REC = 24 floats):
  0:9   c1, c2, c3        (intersection constants)
  9:12  a3                (tmat w column: intersection depth)
  12:15 color
  15:18 normal (view space)
  18    opacity
  19:21 filter_center     (screen-space low-pass)
  21    splat id (as f32, stamped by binning; exact below 2^24)
  22    te2, 23 fr2       (adaptive coverage bounds, binning only)

Output channel layout (OUT_CH = 16):
  0:3 rgb (alpha-weighted, pre-background)   3 T_final
  4 expected depth (unnormalized)            5:8 normal
  8 median depth                             9 distortion
  10 m1   11 m2   12 last contributor (f32)  13:16 pad
"""

from __future__ import annotations

import ctypes

import torch

from tpu2dgs_torch.native import build as native
from tpu2dgs_torch.raster import binning, select_kernel
from tpu2dgs_torch.raster.common import (
    ALPHA_CLAMP,
    ALPHA_MIN,
    CUTOFF,
    DIST_FAR,
    DIST_NEAR,
    FILTER_INV_SQUARE,
    INTERSECT_NEAR,
    MEDIAN_T,
    T_EPS,
)
from tpu2dgs_torch.raster.preprocess import SplatScreen

REC = 24
OUT_CH = 16
BY = 16   # tile pixel rows
BX = 128  # tile pixel columns
CHUNK = 64   # records per early-exit check (the kernel's staging chunk)
# The JAX backend's record-staging group: capk and the packed gradient
# capacity round to whole groups of it, which changes results under
# overflow, so the port keeps the value.
GROUP = 256


def pack_records(splats: SplatScreen) -> torch.Tensor:
    """(N, REC) per-splat records; channel 21 (the id) is stamped later."""
    tmat = splats.tmat
    a1 = tmat[:, :, 0]
    a2 = tmat[:, :, 1]
    a3 = tmat[:, :, 2]
    c1 = -torch.linalg.cross(a3, a2, dim=-1)
    c2 = -torch.linalg.cross(a1, a3, dim=-1)
    c3 = torch.linalg.cross(a1, a2, dim=-1)
    n = tmat.shape[0]
    return torch.cat(
        [
            c1, c2, c3, a3,
            splats.color,
            splats.normal,
            splats.opacity[:, None],
            splats.filter_center.detach(),
            torch.zeros((n, 1), dtype=tmat.dtype, device=tmat.device),
            splats.te2.detach()[:, None],
            splats.fr2.detach()[:, None],
        ],
        dim=-1,
    )


def _map_depth(d):
    safe = torch.clamp(d, min=1e-6)
    return DIST_FAR * (safe - DIST_NEAR) / ((DIST_FAR - DIST_NEAR) * safe)


def _splat_response(r, px, py):
    """Per-pixel response of one record per tile: r = 21 tensors
    broadcastable against the px/py planes.

    Returns (alpha, depthp, hit, G, su, sv, inv, not_clamped, use3d)."""
    pu = px * r[0] + py * r[3] + r[6]
    pv = px * r[1] + py * r[4] + r[7]
    pw = px * r[2] + py * r[5] + r[8]
    valid = pw != 0.0
    inv = torch.where(valid, 1.0, 0.0) / torch.where(valid, pw, 1.0)
    su = pu * inv
    sv = pv * inv
    rho3d = su * su + sv * sv
    dx = px - r[19]
    dy = py - r[20]
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    use3d = rho3d <= rho2d
    rho = torch.where(use3d, rho3d, rho2d)
    inside = (rho3d <= CUTOFF * CUTOFF) | (rho2d <= rho3d)
    depthp = su * r[9] + sv * r[10] + r[11]
    G = torch.exp(-0.5 * rho)
    raw = r[18] * G
    not_clamped = raw < ALPHA_CLAMP
    alpha = torch.clamp(raw, max=ALPHA_CLAMP)
    hit = valid & inside & (depthp >= INTERSECT_NEAR) & (alpha >= ALPHA_MIN)
    return alpha, depthp, hit, G, su, sv, inv, not_clamped, use3d


def _tile_planes(t, nty, device):
    """Pixel-center coordinates (T, BY, BX) of column-major tiles."""
    tiles = torch.arange(t, device=device)
    x0 = ((tiles // nty) * BX).to(torch.float32)[:, None, None]
    y0 = ((tiles % nty) * BY).to(torch.float32)[:, None, None]
    px = x0 + torch.arange(BX, device=device, dtype=torch.float32)[None, None, :]
    py = y0 + torch.arange(BY, device=device, dtype=torch.float32)[None, :, None]
    return px.expand(t, BY, BX), py.expand(t, BY, BX)


def blend_tiles_plain(rec3: torch.Tensor, counts: torch.Tensor, nty: int) -> torch.Tensor:
    """Plain PyTorch forward blend: all tiles walk their lists in lockstep.

    rec3 (T, NCH, capk) f32 channel-major record lists, counts (T,) live
    entries per tile -> (T, OUT_CH, BY, BX), the kernel's math and layout."""
    t, _, capk = rec3.shape
    dev = rec3.device
    px, py = _tile_planes(t, nty, dev)
    counts = torch.clamp(counts.to(torch.int64), max=capk)

    def f(v):
        return torch.full((t, BY, BX), v, dtype=torch.float32, device=dev)

    T, alive = f(1.0), torch.ones((t, BY, BX), dtype=torch.bool, device=dev)
    rgb = [f(0.0) for _ in range(3)]
    nrm = [f(0.0) for _ in range(3)]
    dep, med, m1, m2, dist, last = f(0.0), f(0.0), f(0.0), f(0.0), f(0.0), f(-1.0)
    n_walk = int(counts.max()) if t else 0
    for j in range(n_walk):
        r = [rec3[:, k, j, None, None] for k in range(21)]
        alpha, depthp, hit, *_ = _splat_response(r, px, py)
        ok = hit & alive & (j < counts)[:, None, None]
        test_t = T * (1.0 - alpha)
        kill = ok & (test_t < T_EPS)
        alive = alive & ~kill
        a = torch.where(ok & ~kill, alpha, 0.0)
        w = a * T
        blended = a > 0.0
        med = torch.where(blended & (T > MEDIAN_T), depthp, med)
        last = torch.where(blended, float(j), last)
        m = _map_depth(depthp)
        dist = dist + w * (m * m * (1.0 - T) + m2 - 2.0 * m * m1)
        m1 = m1 + w * m
        m2 = m2 + w * m * m
        T = T * (1.0 - a)
        rgb = [acc + w * r[12 + i] for i, acc in enumerate(rgb)]
        dep = dep + w * depthp
        nrm = [acc + w * r[15 + i] for i, acc in enumerate(nrm)]
        if (j + 1) % CHUNK == 0 and not bool(alive.any()):
            break  # every pixel saturated: the rest would add nothing
    zeros = f(0.0)
    return torch.stack(
        [*rgb, T, dep, *nrm, med, dist, m1, m2, last, zeros, zeros, zeros], dim=1)


_BLEND_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def blend_tiles(rec3: torch.Tensor, counts: torch.Tensor, nty: int) -> torch.Tensor:
    """Forward blend of per-tile record lists -> (T, OUT_CH, BY, BX).

    A CPU tensor runs `blend_tiles_plain`; a CUDA tensor launches the
    kernel (csrc/blend_forward.cu) or raises."""
    dev = rec3.device
    if dev.type == "cpu":
        return blend_tiles_plain(rec3, counts, nty)
    if dev.type != "cuda":
        raise ValueError(f"blend_tiles runs on cpu or cuda, not {dev}")
    if rec3.dtype != torch.float32 or rec3.dim() != 3 or not rec3.is_contiguous():
        raise ValueError("rec3 must be a contiguous (T, NCH, capk) float32 tensor")
    t, nch, capk = rec3.shape
    if nch < 21:
        raise ValueError(f"rec3 has {nch} channels; the blend reads 21")
    if (counts.dtype != torch.int32 or counts.shape != (t,) or counts.device != dev
            or not counts.is_contiguous()):
        raise ValueError("counts must be a contiguous (T,) int32 tensor on rec3's device")
    out = torch.empty((t, OUT_CH, BY, BX), dtype=torch.float32, device=dev)
    fn = native.function("blend_forward", "blend_forward_launch", _BLEND_ARGTYPES)
    native.launch(fn, rec3.data_ptr(), counts.data_ptr(), out.data_ptr(), t, nch,
                  capk, nty, dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
                  what="blend_tiles")
    return out


def _effective_counts(counts, out, group):
    """Per-tile group-aligned EFFECTIVE entry counts: entries past the
    tile's last contributor (out channel 12) are never walked by the
    backward, so they reserve no packed gradient rows."""
    li = torch.amax(out[:, 12], dim=(1, 2)).to(torch.int64)  # -1 = none
    walked = torch.where(li < 0, 0, (li // group + 1) * group)
    return torch.minimum(-(-counts.to(torch.int64) // group) * group, walked)


def rasterize_cuda(splats: SplatScreen, settings, bg_color: torch.Tensor,
                   plain: bool = False):
    """(image (H,W,3), allmap) of the preprocessed splats: the counterpart
    of rasterize_pallas on one device (the full image, tile_row0 = 0).

    `plain=True` runs the kernels' plain PyTorch versions on any device
    (as the JAX backend's interpret=True runs its kernels' semantics),
    for holding the kernels against them on the card."""
    w, h = settings.width, settings.height
    n = splats.tmat.shape[0]
    nbx = -(-w // BX)
    nty = -(-h // BY)

    cap = min(settings.tile_capacity, max(n, 1))
    bin_cap = max(min(settings.bin_capacity, max(n, 1)), cap)
    k_vis = min(settings.vis_capacity or n, n)

    if n >= 1 << 24:
        # Splat ids ride an f32 channel through binning (exact < 2^24).
        raise ValueError(f"cuda backend: {n} splats >= 2^24 exceeds the f32 id channel")
    comp = binning.compact_visible(splats, k_vis)
    rec = pack_records(splats)
    n_vis = torch.clamp(comp.num_visible, max=k_vis)

    col_cap = settings.col_capacity
    rec3, raw_counts, bin_counts, col_counts = _bin_records(
        comp.x0, comp.x1, comp.y0, comp.y1, n_vis, rec.detach(), nbx, nty,
        bin_cap, cap, col_cap=col_cap, ids=comp.perm, plain=plain)

    f32 = torch.float32
    aux = {
        "_aux_bin_overflow_frac": torch.mean((bin_counts > bin_cap).to(f32)),
        "_aux_col_overflow_frac": torch.mean((col_counts > col_cap).to(f32)),
        "_aux_vis_overflow": (comp.num_visible > k_vis).to(f32),
        "_aux_bin_count_max": torch.amax(bin_counts).to(f32),
        "_aux_col_count_max": torch.amax(col_counts).to(f32),
    }
    return blend_binned(rec3, raw_counts, settings, bg_color, nbx, nty, aux,
                        plain=plain)


def blend_binned(rec3, raw_counts, settings, bg_color, nbx, nty, aux, plain=False):
    """Blend pre-binned, depth-ordered record lists into (image, allmap).

    rec3 (T, NCH, capk) channel-major per-tile record lists from
    _bin_records, raw_counts (T,) total overlaps. `aux` = extra _aux_*
    diagnostics merged into allmap."""
    w, h = settings.width, settings.height
    t, _, capk = rec3.shape
    counts = torch.clamp(raw_counts, max=capk).to(torch.int32)

    # Packed gradient capacity, as the backward will size it: reported now
    # so the overflow counters and keys match the JAX backend.
    pack_cap = settings.grad_pack_capacity or (16 * _round128(capk) * nbx)
    pack_cap = min(_round128(pack_cap), _round128(t * capk))
    grp = min(GROUP, capk)
    pack_cap = -(-pack_cap // grp) * grp

    blend = blend_tiles_plain if plain else blend_tiles
    out = blend(rec3, counts, nty)

    def untile(ch):
        # column-major tile rows: t = tix*nty + tiy
        a = out[:, ch].reshape(nbx, nty, BY, BX)
        return a.permute(1, 2, 0, 3).reshape(nty * BY, nbx * BX)[:h, :w]

    pack_demand = torch.sum(_effective_counts(counts, out, grp))

    f32 = torch.float32
    t_final = untile(3)
    image = torch.stack([untile(0), untile(1), untile(2)], dim=-1)
    image = image + t_final[..., None] * bg_color[None, None, :]
    allmap = {
        "depth_expected": untile(4),
        "alpha": 1.0 - t_final,
        "normal": torch.stack([untile(5), untile(6), untile(7)], dim=-1),
        "depth_median": untile(8),
        "distortion": untile(9),
        # fraction of tiles whose overlap set exceeded capacity (tail cut)
        "_aux_tile_overflow_frac": torch.mean((raw_counts > capk).to(f32)),
        # 1.0 when the packed gradient rows would exceed grad_pack_capacity
        "_aux_grad_pack_overflow_frac": (pack_demand > pack_cap).to(f32),
        "_aux_tile_count_max": torch.amax(raw_counts).to(f32),
        "_aux_grad_pack_max": pack_demand.to(f32),
        # work actually blended (sum of capacity-clamped tile entries)
        "_aux_strip_work": torch.sum(counts).to(f32),
        **aux,
    }
    return image, allmap


def _round128(x: int) -> int:
    return max(128, -(-x // 128) * 128)


def _round_group(x: int) -> int:
    """Round a per-tile capacity up so the staging group min(GROUP, capk)
    divides it: 128-multiples below GROUP, whole GROUP-multiples above."""
    x = max(128, -(-x // 128) * 128)
    return x if x <= GROUP else -(-x // GROUP) * GROUP


# The record-carrying binning levels (L2, L3) carry all REC record
# channels (NCH in the shapes below). The exact test reads c1/c2/c3 (0:9), filter_center (19:21),
# te2 (22), fr2 (23). Pad rows never hit through the exact test: an
# ellipse (a=c=1, b=0) centered at -1e9 with te2 < 0, circle at 1e9 with
# fr2 < 0.
_EXACT_IDX = tuple(range(9)) + (19, 20, 22, 23)
_REC_PADS = tuple(
    {0: 1.0, 4: 1.0, 6: 1e9, 7: 1e9, 19: 1e9, 22: -1.0, 23: -1.0}.get(c, 0.0)
    for c in range(REC))


def _bin_records(x0, x1, y0, y1, n_vis, rec_sg, nbx, nty, bin_cap, cap,
                 tile_row0=0, col_cap=32768, ids=None, plain=False):
    """Three-level record-carrying binning: columns -> coarse bins -> tiles.

    x0..y1: (K,) screen binning AABBs in depth-ascending order (never-hit
    boxes past n_vis); rec_sg: records indexed by the id channel — rows of
    rec_sg[ids[slot]] (ids (K,) int; None = arange(K), rec_sg in box
    order). One device renders the full image: tile_row0 must be 0 (the
    strip and work-window modes of the JAX backend come with the
    multi-device slice).

    Returns (rec3 (T, NCH, capk) f32 channel-major per-tile record lists,
    counts (T,), bin_counts (NB,), col_counts (nbx,)).

      L1: screen columns (one BX-wide tile column each) select box + id
          channels from the global compacted array, AABB test; one row
          gather then builds the column record lists.
      L2: coarse bins (1 column x 4 tile rows, column-major) select full
          records from their column's candidates under the exact test.
      L3: 16x128 tiles select from their bin's candidates, exact test.
    """
    if tile_row0 != 0:
        raise NotImplementedError("tile-row strips come with the multi-device slice")
    select = select_kernel.select_values_plain if plain else select_kernel.select_values
    dev = x0.device
    f32 = torch.float32
    cby = 4  # coarse bin = (BX, 4*BY) px
    nby_c = -(-nty // cby)

    kp = _round128(x0.shape[0])
    col_cap = _round128(min(col_cap, kp))
    bin_capk = _round128(min(bin_cap, col_cap))
    capk = _round_group(min(cap, bin_capk))

    # L1: columns over the full image height, AABB test. The record-row id
    # rides as an f32 channel (exact: ids < 2^24).
    if ids is None:
        g0 = torch.arange(x0.shape[0], dtype=f32, device=dev)[None, :]
    else:
        g0 = ids.to(f32)[None, :]
    y_lo = torch.zeros((nbx,), dtype=f32, device=dev)
    y_hi = y_lo + (nty * BY - 1)
    cix = torch.arange(nbx, dtype=f32, device=dev)
    cchan, col_cnt = select(
        (cix * BX, cix * BX + (BX - 1), y_lo, y_hi),
        (x0[None], x1[None], y0[None], y1[None], g0),
        torch.zeros((nbx,), dtype=torch.int32, device=dev), col_cap,
        parent_counts=n_vis.to(torch.int32).expand(nbx))

    # Column record lists: the one gather of the design. Channel 21 is
    # stamped with the record-row id; the tail past each column's count is
    # overwritten with never-hit pad records (slot pad 0 would otherwise
    # gather live record 0 into L2).
    slot_f = cchan[:, 4]                                   # (nbx, col_cap)
    rec_col = rec_sg[slot_f.to(torch.int64)].permute(0, 2, 1).contiguous()
    rec_col[:, 21, :] = slot_f
    live_col = (torch.arange(rec_col.shape[2], device=dev)
                < torch.clamp(col_cnt, max=col_cap)[:, None])[:, None, :]
    pads = torch.tensor(_REC_PADS, dtype=f32, device=dev)[None, :, None]
    l2_in = torch.where(live_col, rec_col, pads)           # (nbx, NCH, col_cap)

    # L2: coarse bins from their column's candidates, exact coverage.
    nb = nby_c * nbx
    bi = torch.arange(nb, dtype=torch.int64, device=dev)
    bix = (bi // nby_c).to(f32)
    biy = (bi % nby_c).to(f32)
    by0 = biy * (BY * cby)
    by1 = by0 + (BY * cby - 1)
    bin_parent = bi // nby_c
    bchan, bin_counts = select(
        (bix * BX, bix * BX + (BX - 1), by0, by1),
        l2_in, bin_parent, bin_capk,
        parent_counts=torch.clamp(col_cnt, max=col_cap)[bin_parent],
        box_idx=None, exact_idx=_EXACT_IDX, pad_vals=_REC_PADS)

    # L3: fine tiles from their bin's candidates, exact coverage.
    t = nty * nbx
    tix = torch.arange(t, dtype=torch.int64, device=dev) // nty
    tiy = torch.arange(t, dtype=torch.int64, device=dev) % nty
    bin_of_tile = tix * nby_c + tiy // cby
    tx0 = (tix * BX).to(f32)
    ty0 = (tiy * BY).to(f32)
    rec3, counts = select(
        (tx0, tx0 + (BX - 1), ty0, ty0 + (BY - 1)),
        bchan, bin_of_tile, capk,
        parent_counts=torch.clamp(bin_counts, max=bin_capk)[bin_of_tile],
        box_idx=None, exact_idx=_EXACT_IDX, pad_vals=_REC_PADS)
    return rec3, counts, bin_counts, col_cnt
