"""Fused CUDA rasterizer, forward and backward (port of
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
  * `blend_tiles_backward`: the backward blend kernel
    (csrc/blend_backward.cu, replacing the TPU `_bwd_kernel`) on CUDA
    tensors, `blend_tiles_backward_plain` on CPU tensors: one packed
    20-float gradient row per walked list entry.
  * Both kernels cut a tile into 8 sub-tiles of 16x16 pixels, and each warp
    walks only the entries whose exact coverage reaches its 16x4 block of a
    sub-tile (plain: `subtile_coverage`); K2 runs one CTA per sub-tile, K3
    one cluster of 8 CTAs per tile that combines its rows through
    distributed shared memory. The cull reads te2 and fr2, so both need all
    24 channels.
  * `BlendTiles`: the autograd function joining the two (the JAX
    backend's custom_vjp `blend_tiles`): the packed rows are scattered
    onto the rows of the differentiable record array `rec_c`.
  * `blend_binned`: untile into image planes plus the `_aux_*` counters.

Capacities round exactly as the JAX backend rounds them (`_round128`,
`_round_group` with GROUP = 256), so per-tile lists, counts, overflow
counters and the gradient rows dropped under overflow agree.

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
SUB = 16  # sub-tile width of the blend kernels' cull (BY x SUB pixels)
CHUNK = 64   # records per early-exit check (the kernel's staging chunk)
OUTREC = 20  # packed gradient row: d(record channels 0:19) + the record row id
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


def subtile_coverage(rec3: torch.Tensor, counts: torch.Tensor, nty: int,
                     rows: int = BY) -> torch.Tensor:
    """The blend kernels' cull, plain: (T, BX // SUB * (BY // rows), capk)
    bool, by default (T, 8, capk).

    Block b of tile t covers pixel columns [SUB r, SUB r + SUB - 1] and rows
    [rows q, rows q + rows - 1] of the tile, r, q = divmod(b, BY // rows):
    with rows = BY the 8 sub-tiles of 16x16 pixels, with rows = 4 the 16x4
    blocks of the kernels' warps. Entry j reaches it when j < counts[t] and
    the exact coverage test passes on the block's inclusive rectangle, as
    binning's L3 tests whole tiles. The kernels walk only such pairs; a pair
    whose bit is clear must miss every pixel of the block. For tests and the
    smoke run only: the kernels compute it themselves
    (csrc/blend_common.cuh)."""
    t, _, capk = rec3.shape
    dev = rec3.device
    tiles = torch.arange(t, device=dev)
    blocks = torch.arange(BX // SUB * (BY // rows), device=dev)
    r, q = blocks // (BY // rows), blocks % (BY // rows)
    x0 = ((tiles // nty) * BX)[:, None, None] + (SUB * r)[None, :, None]
    y0 = ((tiles % nty) * BY)[:, None, None] + (rows * q)[None, :, None]
    x0, y0 = x0.to(torch.float32), y0.to(torch.float32)
    hit = select_kernel._exact_coverage(lambda c: rec3[:, c, None, :], _EXACT_IDX,
                                        x0, x0 + (SUB - 1), y0, y0 + (rows - 1))
    live = torch.arange(capk, device=dev)[None, :] < counts.to(torch.int64)[:, None]
    return hit & live[:, None, :]


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
    if nch < REC:
        raise ValueError(f"rec3 has {nch} channels; the blend reads {REC} (its sub-tile "
                         "cull reads te2 and fr2)")
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


def _packed_offsets(counts, out, group):
    """Global packed row cursor per tile: the exclusive prefix sum of the
    group-aligned effective counts in column-major tile order. (T,) int32."""
    cc = _effective_counts(counts, out, group)
    return (torch.cumsum(cc, dim=0) - cc).to(torch.int32)


def blend_tiles_backward_plain(rec3, counts, off, out, dout, nty: int,
                               pack_cap: int) -> torch.Tensor:
    """Plain PyTorch backward blend: all tiles walk their lists back to
    front in lockstep. Returns the packed rows (pack_cap, OUTREC).

    Tile t's row for list entry j lies at packed row off[t] + j. Every row
    of a tile's reserved region (its group-aligned effective count) is
    written, zeros where the walk produced nothing, unless the row's group
    of min(GROUP, capk) rows would end past pack_cap: such a group is
    dropped whole. Rows no tile reserved are zero here (the kernel leaves
    them unwritten; `BlendTiles` masks them). Channels 0:19 are the
    gradients of record channels 0:19 summed over the tile's pixels;
    channel 19 is record channel 21, the row of the record array."""
    t, _, capk = rec3.shape
    dev = rec3.device
    group = min(GROUP, capk)
    px, py = _tile_planes(t, nty, dev)
    counts = torch.clamp(counts.to(torch.int64), max=capk)
    off = off.to(torch.int64)

    t_final, m1_final, m2_final, last = out[:, 3], out[:, 10], out[:, 11], out[:, 12]
    d_rgb = (dout[:, 0], dout[:, 1], dout[:, 2])
    d_dep = dout[:, 4]
    d_nrm = (dout[:, 5], dout[:, 6], dout[:, 7])
    d_med, d_dist = dout[:, 8], dout[:, 9]
    dt_term = dout[:, 3] * t_final

    max_last = torch.amax(last, dim=(1, 2)).to(torch.int64)
    walked_to = torch.where(max_last < 0, 0, (max_last // CHUNK + 1) * CHUNK)  # (T,)
    eff = _effective_counts(counts, out, group)
    n_walk = int(walked_to.max()) if t else 0
    n_rows = int(eff.max()) if t else 0

    zeros = torch.zeros((t, BY, BX), dtype=torch.float32, device=dev)
    T_cur = t_final.clone()
    acc_w, s_w, s_wm, acc_a, s_wm2 = (zeros.clone() for _ in range(5))
    med_done = torch.zeros((t, BY, BX), dtype=torch.bool, device=dev)
    rows = torch.zeros((t, n_rows, OUTREC), dtype=torch.float32, device=dev)
    dm_scale = DIST_FAR * DIST_NEAR / (DIST_FAR - DIST_NEAR)

    for j in range(n_walk - 1, -1, -1):
        r = [rec3[:, k, j, None, None] for k in range(21)]
        alpha, depthp, hit, G, su, sv, inv, nc, u3 = _splat_response(r, px, py)
        in_list = j < counts
        blended = hit & (float(j) <= last) & in_list[:, None, None]
        a = torch.where(blended, alpha, 0.0)
        t_before = torch.where(blended, T_cur / (1.0 - a), T_cur)
        w = a * t_before

        m = _map_depth(depthp)
        wm = w * m
        wm2 = wm * m
        m1b = m1_final - s_wm - wm
        m2b = m2_final - s_wm2 - wm2
        a_before = 1.0 - t_before
        mm = m * m
        two_m = 2.0 * m

        dldw = (d_rgb[0] * r[12] + d_rgb[1] * r[13] + d_rgb[2] * r[14]
                + d_dep * depthp
                + d_nrm[0] * r[15] + d_nrm[1] * r[16] + d_nrm[2] * r[17]
                + d_dist * (mm * a_before + m2b - two_m * m1b + mm * s_w - two_m * s_wm))

        # median: first blended record, back to front, with T before it > 0.5
        is_med = blended & (t_before > MEDIAN_T) & ~med_done
        med_done = med_done | is_med

        d_m = d_dist * (w * (two_m * a_before - 2.0 * m1b) + w * (two_m * s_w - 2.0 * s_wm))
        dm_dd = dm_scale / (torch.clamp(depthp, min=1e-6) ** 2)
        d_d = d_dep * w + d_m * dm_dd + torch.where(is_med, d_med, 0.0)

        one_minus = torch.clamp(1.0 - a, min=1.0 - ALPHA_CLAMP)
        d_a = dldw * t_before + (acc_a - acc_w - dt_term) / one_minus

        # Suffix sums take blended pixels only (elsewhere w = 0 and the
        # terms vanish, but a non-finite miss must not poison the carry).
        acc_w = torch.where(blended, acc_w + dldw * w, acc_w)
        acc_a = torch.where(blended, acc_a + d_dist * w * m * m * t_before, acc_a)
        s_w = s_w + w
        s_wm = torch.where(blended, s_wm + wm, s_wm)
        s_wm2 = torch.where(blended, s_wm2 + wm2, s_wm2)
        T_cur = t_before

        d_op = torch.where(nc, G * d_a, 0.0)
        d_rho = torch.where(nc, -0.5 * r[18] * G * d_a, 0.0)
        d_rho3d = torch.where(u3, d_rho, 0.0)  # low-pass branch: no gradient
        d_su = 2.0 * su * d_rho3d + r[9] * d_d
        d_sv = 2.0 * sv * d_rho3d + r[10] * d_d
        d_pu = d_su * inv
        d_pv = d_sv * inv
        d_pw = -(su * d_su + sv * d_sv) * inv
        planes = [px * d_pu, px * d_pv, px * d_pw, py * d_pu, py * d_pv, py * d_pw,
                  d_pu, d_pv, d_pw, su * d_d, sv * d_d, d_d,
                  w * d_rgb[0], w * d_rgb[1], w * d_rgb[2],
                  w * d_nrm[0], w * d_nrm[1], w * d_nrm[2], d_op]
        grad = torch.where(blended[:, None], torch.stack(planes, dim=1), 0.0)
        rows[:, j, :OUTREC - 1] = grad.sum(dim=(2, 3))
        rows[:, j, OUTREC - 1] = torch.where(in_list & (j < walked_to), rec3[:, 21, j], 0.0)

    dpack = torch.zeros((pack_cap + 1, OUTREC), dtype=torch.float32, device=dev)
    jj = torch.arange(n_rows, device=dev)[None, :]
    kept = (jj < eff[:, None]) & (off[:, None] + (jj // group + 1) * group <= pack_cap)
    dest = torch.where(kept, off[:, None] + jj, pack_cap)  # pack_cap = the dump row
    dpack.index_copy_(0, dest.reshape(-1), rows.reshape(-1, OUTREC))
    return dpack[:pack_cap]


_BLEND_BWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def blend_tiles_backward(rec3, counts, off, out, dout, nty: int,
                         pack_cap: int) -> torch.Tensor:
    """Packed gradient rows (pack_cap, OUTREC) of the forward blend.

    CPU tensors run `blend_tiles_backward_plain`; CUDA tensors launch the
    kernel (csrc/blend_backward.cu) or raise. The kernel writes only the
    rows that tiles reserved and that fit: the others are uninitialized."""
    dev = rec3.device
    if dev.type == "cpu":
        return blend_tiles_backward_plain(rec3, counts, off, out, dout, nty, pack_cap)
    if dev.type != "cuda":
        raise ValueError(f"blend_tiles_backward runs on cpu or cuda, not {dev}")
    if rec3.dtype != torch.float32 or rec3.dim() != 3 or not rec3.is_contiguous():
        raise ValueError("rec3 must be a contiguous (T, NCH, capk) float32 tensor")
    t, nch, capk = rec3.shape
    group = min(GROUP, capk)
    if nch < REC or capk % group or group % CHUNK or pack_cap % group:
        raise ValueError(f"rec3 {tuple(rec3.shape)}, pack_cap {pack_cap}: the backward "
                         f"blend reads {REC} channels and walks whole staging groups")
    for name, a in (("counts", counts), ("off", off)):
        if a.dtype != torch.int32 or a.shape != (t,) or a.device != dev or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (T,) int32 tensor on rec3's device")
    for name, a in (("out", out), ("dout", dout)):
        if (a.dtype != torch.float32 or a.shape != (t, OUT_CH, BY, BX) or a.device != dev
                or not a.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (T, {OUT_CH}, {BY}, {BX}) float32 "
                             "tensor on rec3's device")
    dpack = torch.empty((pack_cap, OUTREC), dtype=torch.float32, device=dev)
    fn = native.function("blend_backward", "blend_backward_launch", _BLEND_BWD_ARGTYPES)
    native.launch(fn, rec3.data_ptr(), counts.data_ptr(), off.data_ptr(), out.data_ptr(),
                  dout.data_ptr(), dpack.data_ptr(), t, nch, capk, nty, group, pack_cap,
                  dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
                  what="blend_tiles_backward")
    return dpack


def blend_occupancy(device: torch.device) -> dict:
    """What the card holds at once of each blend kernel (the CUDA
    occupancy calculator): K2's CTAs per SM; K3's clusters of 8 CTAs on the
    card, its CTAs per SM and its dynamic shared memory per CTA."""
    ctas, clusters, bwd_ctas, smem = (ctypes.c_int() for _ in range(4))
    idx = device.index or 0
    fn = native.function("blend_forward", "blend_forward_occupancy",
                         [ctypes.c_int, ctypes.c_void_p])
    native.check(fn(idx, ctypes.byref(ctas)), what="blend_forward_occupancy")
    fn = native.function("blend_backward", "blend_backward_occupancy",
                         [ctypes.c_int] + [ctypes.c_void_p] * 3)
    native.check(fn(idx, ctypes.byref(clusters), ctypes.byref(bwd_ctas), ctypes.byref(smem)),
                 what="blend_backward_occupancy")
    return {"blend_tiles": {"ctas_per_sm": ctas.value},
            "blend_tiles_backward": {"clusters": clusters.value, "ctas_per_sm": bwd_ctas.value,
                                     "dynamic_smem_bytes": smem.value}}


def scatter_packed(dpack, eff, num_records: int) -> torch.Tensor:
    """Sum packed gradient rows onto their record rows -> (num_records, REC).

    Rows past min(demand, pack_cap) were never written: they are masked
    to a zero added to row 0. Channels 19:24 of a record carry no
    gradient."""
    pack_cap = dpack.shape[0]
    written = torch.clamp(torch.sum(eff), max=pack_cap)
    live_row = torch.arange(pack_cap, device=dpack.device) < written
    idx = torch.where(live_row, dpack[:, OUTREC - 1].to(torch.int64), 0)
    dsum = torch.zeros((num_records, OUTREC), dtype=dpack.dtype, device=dpack.device)
    dsum.index_add_(0, idx, torch.where(live_row[:, None], dpack, 0.0))
    return torch.cat([dsum[:, :OUTREC - 1],
                      dsum.new_zeros((num_records, REC - (OUTREC - 1)))], dim=1)


class BlendTiles(torch.autograd.Function):
    """Blend pre-binned record lists; the backward routes gradients to the
    rows of `rec_c` (N, REC), the differentiable records whose data the
    forward never reads: rec3 holds copies of them, each with its row of
    rec_c in channel 21."""

    @staticmethod
    def forward(ctx, rec_c, rec3, counts, nty, pack_cap, plain):
        out = (blend_tiles_plain if plain else blend_tiles)(rec3, counts, nty)
        ctx.save_for_backward(rec3, counts, out)
        ctx.args = (rec_c.shape[0], nty, pack_cap, plain)
        return out

    @staticmethod
    def backward(ctx, dout):
        rec3, counts, out = ctx.saved_tensors
        num_records, nty, pack_cap, plain = ctx.args
        group = min(GROUP, rec3.shape[2])
        eff = _effective_counts(counts, out, group)
        off = (torch.cumsum(eff, dim=0) - eff).to(torch.int32)
        backward = blend_tiles_backward_plain if plain else blend_tiles_backward
        dpack = backward(rec3, counts, off, out, dout.contiguous(), nty, pack_cap)
        return scatter_packed(dpack, eff, num_records), None, None, None, None, None


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
    # The id channel of the lists carries original splat ids (comp.perm), so
    # the backward scatters straight onto the rows of `rec`.
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
    return blend_binned(rec, rec3, raw_counts, settings, bg_color, nbx, nty, aux,
                        plain=plain)


def blend_binned(rec_c, rec3, raw_counts, settings, bg_color, nbx, nty, aux, plain=False):
    """Blend pre-binned, depth-ordered record lists into (image, allmap).

    rec_c (N, REC): the differentiable records whose rows the lists' id
    channel indexes, the gradient target. rec3 (T, NCH, capk)
    channel-major per-tile record lists from _bin_records (no gradient
    flows through them), raw_counts (T,) total overlaps. `aux` = extra
    _aux_* diagnostics merged into allmap."""
    w, h = settings.width, settings.height
    t, _, capk = rec3.shape
    counts = torch.clamp(raw_counts, max=capk).to(torch.int32)

    # Global capacity of the backward's packed gradient rows, a whole
    # number of staging groups: offsets are group-aligned, and a group is
    # written whole or dropped whole.
    pack_cap = settings.grad_pack_capacity or (16 * _round128(capk) * nbx)
    pack_cap = min(_round128(pack_cap), _round128(t * capk))
    grp = min(GROUP, capk)
    pack_cap = -(-pack_cap // grp) * grp

    out = BlendTiles.apply(rec_c, rec3, counts, nty, pack_cap, plain)

    def untile(ch):
        # column-major tile rows: t = tix*nty + tiy
        a = out[:, ch].reshape(nbx, nty, BY, BX)
        return a.permute(1, 2, 0, 3).reshape(nty * BY, nbx * BX)[:h, :w]

    pack_demand = torch.sum(_effective_counts(counts, out.detach(), grp))

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


CBY = 4  # a coarse bin is one tile column wide and CBY tile rows high


def _level_caps(k: int, bin_cap: int, cap: int, col_cap: int):
    """(col_cap, bin_capk, capk): the output capacities of the three
    levels for K compacted splats."""
    col_cap = _round128(min(col_cap, _round128(k)))
    bin_capk = _round128(min(bin_cap, col_cap))
    return col_cap, bin_capk, _round_group(min(cap, bin_capk))


def _l1_args(x0, x1, y0, y1, n_vis, nbx, nty, ids=None) -> dict:
    """L1's select arguments (all but `cap`): one row per BX-wide screen
    column over the full image height, AABB test. The record-row id rides
    as an f32 channel (exact: ids < 2^24)."""
    dev = x0.device
    f32 = torch.float32
    if ids is None:
        g0 = torch.arange(x0.shape[0], dtype=f32, device=dev)[None, :]
    else:
        g0 = ids.to(f32)[None, :]
    y_lo = torch.zeros((nbx,), dtype=f32, device=dev)
    cix = torch.arange(nbx, dtype=f32, device=dev)
    return dict(
        row_rects=(cix * BX, cix * BX + (BX - 1), y_lo, y_lo + (nty * BY - 1)),
        cand_channels=(x0[None], x1[None], y0[None], y1[None], g0),
        parent_of_row=torch.zeros((nbx,), dtype=torch.int32, device=dev),
        parent_counts=n_vis.to(torch.int32).expand(nbx))


def _column_lists(rec_sg, cchan, col_cnt):
    """Column record lists (nbx, NCH, col_cap) from L1's output: the one
    gather of the design. Channel 21 is stamped with the record-row id;
    the tail past each column's count is overwritten with never-hit pad
    records (slot pad 0 would otherwise gather live record 0 into L2)."""
    dev = cchan.device
    col_cap = cchan.shape[2]
    slot_f = cchan[:, 4]                                   # (nbx, col_cap)
    rec_col = rec_sg[slot_f.to(torch.int64)].permute(0, 2, 1).contiguous()
    rec_col[:, 21, :] = slot_f
    live_col = (torch.arange(col_cap, device=dev)
                < torch.clamp(col_cnt, max=col_cap)[:, None])[:, None, :]
    pads = torch.tensor(_REC_PADS, dtype=torch.float32, device=dev)[None, :, None]
    return torch.where(live_col, rec_col, pads)


def _l2_args(l2_in, col_cnt, nbx, nty) -> dict:
    """L2's select arguments (all but `cap`): coarse bins (column-major)
    from their column's candidates, exact coverage."""
    dev = l2_in.device
    f32 = torch.float32
    nby_c = -(-nty // CBY)
    bi = torch.arange(nby_c * nbx, dtype=torch.int64, device=dev)
    bix = (bi // nby_c).to(f32)
    by0 = (bi % nby_c).to(f32) * (BY * CBY)
    bin_parent = bi // nby_c
    return dict(
        row_rects=(bix * BX, bix * BX + (BX - 1), by0, by0 + (BY * CBY - 1)),
        cand_channels=l2_in, parent_of_row=bin_parent,
        parent_counts=torch.clamp(col_cnt, max=l2_in.shape[2])[bin_parent],
        box_idx=None, exact_idx=_EXACT_IDX, pad_vals=_REC_PADS)


def _l3_args(bchan, bin_counts, nbx, nty) -> dict:
    """L3's select arguments (all but `cap`): 16x128 tiles (column-major)
    from their bin's candidates, exact coverage."""
    dev = bchan.device
    f32 = torch.float32
    nby_c = -(-nty // CBY)
    t = torch.arange(nty * nbx, dtype=torch.int64, device=dev)
    tix, tiy = t // nty, t % nty
    bin_of_tile = tix * nby_c + tiy // CBY
    tx0 = (tix * BX).to(f32)
    ty0 = (tiy * BY).to(f32)
    return dict(
        row_rects=(tx0, tx0 + (BX - 1), ty0, ty0 + (BY - 1)),
        cand_channels=bchan, parent_of_row=bin_of_tile,
        parent_counts=torch.clamp(bin_counts, max=bchan.shape[2])[bin_of_tile],
        box_idx=None, exact_idx=_EXACT_IDX, pad_vals=_REC_PADS)


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

    The levels' arguments come from _l1_args, _column_lists, _l2_args and
    _l3_args, which eval/bin_probe.py times one by one.
    """
    if tile_row0 != 0:
        raise NotImplementedError("tile-row strips come with the multi-device slice")
    select = select_kernel.select_values_plain if plain else select_kernel.select_values
    col_cap, bin_capk, capk = _level_caps(x0.shape[0], bin_cap, cap, col_cap)

    cchan, col_cnt = select(cap=col_cap, **_l1_args(x0, x1, y0, y1, n_vis, nbx, nty, ids))
    l2_in = _column_lists(rec_sg, cchan, col_cnt)           # (nbx, NCH, col_cap)
    bchan, bin_counts = select(cap=bin_capk, **_l2_args(l2_in, col_cnt, nbx, nty))
    rec3, counts = select(cap=capk, **_l3_args(bchan, bin_counts, nbx, nty))
    return rec3, counts, bin_counts, col_cnt
