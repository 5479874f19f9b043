"""Stream compaction: first-K covering candidates per row, every channel
carried (port of tpu2dgs/raster/select_kernel.py).

The heart of binning. Each output row is an inclusive pixel rectangle
with a parent candidate list; the row keeps, in candidate order, the
first `cap` candidates that pass an AABB overlap test (`box_idx`) and/or
the exact splat-coverage test (`exact_idx`: does the perspective-correct
conic {pu^2+pv^2 <= te2 pw^2} or the splat's low-pass circle reach the
rectangle?), carrying every channel through, so binning levels chain with
no gathers between them and the last level's output is the per-tile
record array the blend kernel reads.

`select_counts` returns only the per-row totals of the same test (the
counterpart of the TPU kernel `_count_kernel`, csrc/select_counts.cu).

`select_values` dispatches by device: a CPU tensor runs
`select_values_plain` (a vectorized hit matrix + `binning.first_k_hits`),
a CUDA tensor launches the kernel in csrc/select_values.cu. The kernel
replaces the TPU kernel `_select_values_kernel` and is bit-equal to the
plain version: both copy values, and both evaluate the coverage test with
separately rounded float32 operations in the same order.

The kernel splits every row's walk into chunks of CHUNK candidates and
compacts them in two phases (count, then write at ranks fixed by candidate
order) in one cooperative launch. `chunk_plan` is the grid it launches
with and `compaction_model` the two phases in plain PyTorch, which the CPU
tests hold against `select_values_plain`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tpu2dgs_torch.native import build as native
from tpu2dgs_torch.raster.binning import first_k_hits

LB = 128           # output capacities are multiples of this
MACRO = 8 * LB     # candidates walk in whole macro blocks of 1024

BOX_PADS = (1e9, -1e9, 1e9, -1e9)  # never-hit AABB fills for x0, x1, y0, y1

CHUNK = MACRO      # candidates per work item of the select kernel: one macro block


def _exact_coverage(chan, exact_idx, rx0, rx1, ry0, ry1):
    """Splat-coverage test of candidates vs a pixel rect (plain version).

    `chan(c)` returns channel c of the candidates; `exact_idx` holds the 13
    channel indices r0..r8 (pu = r0 x + r3 y + r6, pv = r1 x + r4 y + r7,
    pw = r2 x + r5 y + r8), fcx, fcy (low-pass circle center), te2 (conic
    tau^2) and fr2 (circle radius^2). The coverage region {rho3d <= te2}
    (as Q = pu^2+pv^2-te2*pw^2 <= 0) union the circle is a superset of the
    blend's per-pixel hit set. Q <= 0 over the rect is decided by the
    minimum over the four clamped edge critical points and the interior
    stationary point: exact for an ellipse; other conics pass."""
    r = [chan(exact_idx[k]) for k in range(9)]
    fcx = chan(exact_idx[9])
    fcy = chan(exact_idx[10])
    te2 = chan(exact_idx[11])
    fr2 = chan(exact_idx[12])

    ccx = torch.clamp(fcx, rx0, rx1)
    ccy = torch.clamp(fcy, ry0, ry1)
    dx = fcx - ccx
    dy = fcy - ccy
    circ = dx * dx + dy * dy <= fr2

    def qval(x, y):
        pu = r[0] * x + r[3] * y + r[6]
        pv = r[1] * x + r[4] * y + r[7]
        pw = r[2] * x + r[5] * y + r[8]
        return pu * pu + pv * pv - te2 * (pw * pw)

    a = r[0] * r[0] + r[1] * r[1] - te2 * (r[2] * r[2])
    b = 2.0 * (r[0] * r[3] + r[1] * r[4] - te2 * (r[2] * r[5]))
    c = r[3] * r[3] + r[4] * r[4] - te2 * (r[5] * r[5])
    d = 2.0 * (r[0] * r[6] + r[1] * r[7] - te2 * (r[2] * r[8]))
    e = 2.0 * (r[3] * r[6] + r[4] * r[7] - te2 * (r[5] * r[8]))

    half = torch.tensor(0.5, dtype=torch.float32, device=a.device)
    one = torch.tensor(1.0, dtype=torch.float32, device=a.device)
    inv2c = torch.div(half, torch.where(c > 0.0, c, one))
    inv2a = torch.div(half, torch.where(a > 0.0, a, one))
    y_a = torch.clamp(-(b * rx0 + e) * inv2c, ry0, ry1)
    y_b = torch.clamp(-(b * rx1 + e) * inv2c, ry0, ry1)
    x_c = torch.clamp(-(b * ry0 + d) * inv2a, rx0, rx1)
    x_d = torch.clamp(-(b * ry1 + d) * inv2a, rx0, rx1)
    best = torch.minimum(
        torch.minimum(qval(rx0, y_a), qval(rx1, y_b)),
        torch.minimum(qval(x_c, ry0), qval(x_d, ry1)),
    )
    det = 4.0 * a * c - b * b
    invdet = torch.div(one, torch.where(det > 0.0, det, one))
    xs = (b * e - 2.0 * c * d) * invdet
    ys = (b * d - 2.0 * a * e) * invdet
    interior = (xs >= rx0) & (xs <= rx1) & (ys >= ry0) & (ys <= ry1)
    best = torch.where(interior, torch.minimum(best, qval(xs, ys)), best)
    not_ell = (a <= 0.0) | (c <= 0.0) | (det <= 0.0)
    return (best <= 0.0) | not_ell | circ


def pad_candidates(stacked: torch.Tensor, m_padded: int, pad_vals) -> torch.Tensor:
    """Pad a stacked (NP, C, M) channel array to M=m_padded."""
    pad = m_padded - stacked.shape[-1]
    if pad <= 0:
        return stacked
    np_, c, _ = stacked.shape
    fills = torch.tensor(pad_vals, dtype=stacked.dtype, device=stacked.device)
    return torch.cat([stacked, fills[None, :, None].expand(np_, c, pad)], dim=-1)


def _prepare(row_rects, cand_channels, parent_of_row, cap, parent_counts,
             pad_vals, box_idx):
    """Shared argument handling of both versions (mirrors the JAX wrapper)."""
    rects = tuple(a.to(torch.float32).contiguous() for a in row_rects)
    r = rects[0].shape[0]
    if isinstance(cand_channels, (tuple, list)):
        stacked = torch.stack([a.to(torch.float32) for a in cand_channels], dim=1)
    else:
        stacked = cand_channels.to(torch.float32)
    _, n_chan, m_in = stacked.shape
    if pad_vals is None:
        if box_idx is None:
            raise ValueError("exact-only rows need explicit pad_vals")
        pad_vals = [0.0] * n_chan
        for bi, v in zip(box_idx, BOX_PADS):
            pad_vals[bi] = v
    pad_vals = tuple(float(v) for v in pad_vals)
    if len(pad_vals) != n_chan:
        raise ValueError(f"{len(pad_vals)} pad values for {n_chan} channels")
    stacked = pad_candidates(stacked, -(-m_in // MACRO) * MACRO, pad_vals).contiguous()
    m = stacked.shape[-1]
    if cap % LB:
        raise ValueError(f"cap {cap} is not a multiple of {LB}")
    if parent_counts is None:
        pcnt = torch.full((r,), m, dtype=torch.int32, device=stacked.device)
    else:
        pcnt = parent_counts.to(torch.int32).contiguous()
    parent = parent_of_row.to(torch.int32).contiguous()
    return rects, stacked, parent, pcnt, pad_vals


def _walked(pcnt, m: int):
    """(R,) int64: the candidates each row walks, whole macro blocks up to
    its parent's count (hits past the count inside the last block still
    count)."""
    return (torch.clamp(pcnt.long(), 0, m) + MACRO - 1) // MACRO * MACRO


def _hits(rects, stacked, parent, box_idx, exact_idx):
    """(R, M) bool: which candidates of its parent list each row hits."""
    rx0, rx1, ry0, ry1 = (a[:, None] for a in rects)
    m = stacked.shape[-1]
    par = parent.long()

    def chan(c):
        return stacked[:, c, :][par]  # (R, M)

    hit = torch.ones((par.shape[0], m), dtype=torch.bool, device=stacked.device)
    if box_idx is not None:
        hit = ((chan(box_idx[0]) <= rx1) & (chan(box_idx[1]) >= rx0)
               & (chan(box_idx[2]) <= ry1) & (chan(box_idx[3]) >= ry0))
    if exact_idx is not None:
        hit = hit & _exact_coverage(chan, exact_idx, rx0, rx1, ry0, ry1)
    return hit


def _walked_hits(rects, stacked, parent, pcnt, box_idx, exact_idx):
    """(R, M) bool: `_hits` over the candidates each row walks. Both plain
    versions start from it."""
    hit = _hits(rects, stacked, parent, box_idx, exact_idx)
    walk = _walked(pcnt, stacked.shape[-1])
    return hit & (torch.arange(hit.shape[1], device=hit.device)[None, :] < walk[:, None])


def _plain(rects, stacked, parent, pcnt, cap, pad_vals, box_idx, exact_idx):
    hit = _walked_hits(rects, stacked, parent, pcnt, box_idx, exact_idx)
    par = parent.long()
    pos, valid, counts = first_k_hits(hit, cap)
    vals = stacked[par[:, None, None],
                   torch.arange(stacked.shape[1], device=hit.device)[None, :, None],
                   pos[:, None, :]]
    pads = torch.tensor(pad_vals, dtype=torch.float32, device=hit.device)
    return torch.where(valid[:, None, :], vals, pads[None, :, None]), counts


def _check_rows(rects, stacked, parent, pcnt) -> int:
    """Raise unless every row array is (R,) on the candidates' device; R."""
    dev = stacked.device
    for name, a in (("parent_of_row", parent), ("parent_counts", pcnt),
                    *(("row_rects", x) for x in rects)):
        if a.device != dev:
            raise ValueError(f"{name} on {a.device}, candidates on {dev}")
    r = rects[0].shape[0]
    if not all(a.shape == (r,) for a in (parent, pcnt, *rects)):
        raise ValueError("row arrays must all be (R,)")
    return r


class ChunkPlan(NamedTuple):
    """The select kernel's grid for one call."""

    chunks: int     # work items per row: M / CHUNK
    items: int      # rows x chunks
    ctas: int       # CTAs of the cooperative grid: min(items, SMs x CTAs per SM)
    group: int      # rows per group of the work order (`work_order`)
    ahead: int      # items the counts run ahead of the writes
    positions: int  # count and write positions of the work order
    scratch: int    # int32 words of scratch: per item a hit count and CHUNK / 4
                    # bytes of hit bits, per row a counter of counted chunks


def chunk_plan(rows: int, m: int, sms: int, ctas_per_sm: int) -> ChunkPlan:
    """The grid the select kernel launches with for R=rows rows of M=m
    candidates (a multiple of MACRO, as `_prepare` pads them), on a device
    of `sms` SMs that holds `ctas_per_sm` of its CTAs each
    (`kernel_occupancy`). Host-known shapes only: no device value is read.
    A group holds enough rows for every CTA to have an item of it, and
    counts run a group and a wave of CTAs ahead of writes."""
    chunks = m // CHUNK
    items = rows * chunks
    ctas = min(items, sms * ctas_per_sm)
    group = max(1, min(rows, -(-ctas // chunks)))
    groups = -(-rows // group)
    return ChunkPlan(chunks, items, ctas, group, group * chunks + ctas,
                     2 * groups * group * chunks, items * (1 + CHUNK // 16) + rows)


COUNT, WRITE = 1, 2


def work_order(plan: ChunkPlan, rows: int):
    """(kind, row, chunk), each (positions,) int64: the order in which the
    kernel's CTAs take count and write work (kind COUNT, WRITE, or 0 for a
    row past the last), the kernel's `work_at`. Items are listed in groups
    of plan.group rows, chunk-major inside a group; counts run plan.ahead
    items ahead of writes and, where both are left, alternate with them."""
    u = plan.group * plan.chunks
    n = plan.positions // 2
    d = min(plan.ahead, n)
    pos = torch.arange(plan.positions)
    q = pos - d
    tail = pos >= 2 * n - d
    odd = (q & 1) == 1
    kind = torch.where(tail | ((pos >= d) & odd), WRITE, COUNT)
    idx = torch.where(tail, pos - n,
                      torch.where(pos < d, pos, torch.where(odd, q >> 1, d + (q >> 1))))
    g, r = idx // u, idx % u
    row = g * plan.group + r % plan.group
    return torch.where(row < rows, kind, 0), row, r // plan.group


def walk_slices(pcnt, m: int):
    """(lo, hi), each (R, M / CHUNK) int64: the candidates [lo, hi) that
    each chunk of a row tests, the chunk's part of the row's walk. The
    walk covers whole macro blocks and a chunk is one, so a chunk is
    either walked whole or not at all."""
    start = torch.arange(m // CHUNK, device=pcnt.device) * CHUNK
    walk = _walked(pcnt, m)[:, None]
    return torch.minimum(start[None, :], walk), torch.minimum(start[None, :] + CHUNK, walk)


def pad_slots(totals, cap: int, chunks: int):
    """(lo, hi), each (R, chunks) int64: the pad slots [lo, hi) that each
    chunk of a row writes: [min(total, cap), cap) split in order into
    shares of whole 128-slot blocks counted from min(total, cap) rounded
    down to 4 slots, so that every share but the first starts on 16 bytes
    (the kernel's formula)."""
    filled = torch.clamp(totals.long(), max=cap)
    base = filled // 4 * 4
    per = ((cap - base + chunks - 1) // chunks + 127) // 128 * 128
    ch = torch.arange(chunks, device=totals.device)
    lo = torch.clamp(base[:, None] + ch[None, :] * per[:, None], max=cap)
    hi = torch.clamp(lo + per[:, None], max=cap)
    return torch.maximum(lo, filled[:, None]), hi


class Compaction(NamedTuple):
    """What `compaction_model` computes, phase by phase."""

    out: torch.Tensor         # (R, C, cap) f32, as select_values
    counts: torch.Tensor      # (R,) int32 TOTAL hits, as select_values
    chunk_hits: torch.Tensor  # (R, chunks) int32: phase 1's count per work item
    first_rank: torch.Tensor  # (R, chunks): the row's hits in earlier chunks
    tested: torch.Tensor      # (R, M) int32: how many chunks tested each candidate
    writes: torch.Tensor      # (R, cap) int32: how many times each output slot was written


def _model(rects, stacked, parent, pcnt, cap, pad_vals, box_idx, exact_idx):
    hit = _hits(rects, stacked, parent, box_idx, exact_idx)
    r, m = hit.shape
    dev = hit.device
    chunks = m // CHUNK
    lo, hi = walk_slices(pcnt, m)
    j = torch.arange(m, device=dev)[None, :]
    # Phase 1: each (row, chunk) tests its slice of the walk and counts.
    in_chunk = [(j >= lo[:, c, None]) & (j < hi[:, c, None]) for c in range(chunks)]
    tested = torch.stack(in_chunk).sum(dim=0, dtype=torch.int32)
    chunk_hits = torch.stack([(hit & s).sum(dim=1, dtype=torch.int32) for s in in_chunk], 1)
    # Phase 2: a chunk's first rank is the row's hits in earlier chunks.
    counts = chunk_hits.sum(dim=1, dtype=torch.int32)
    first = torch.cumsum(chunk_hits, dim=1) - chunk_hits
    out = torch.full((r, stacked.shape[1], cap), float("nan"), device=dev)
    writes = torch.zeros((r, cap), dtype=torch.int32, device=dev)
    pad_lo, pad_hi = pad_slots(counts, cap, chunks)
    slots = torch.arange(cap, device=dev)[None, :]
    pads = torch.tensor(pad_vals, dtype=torch.float32, device=dev)[None, :, None]
    for c in range(chunks):
        h = hit & in_chunk[c]
        rank = first[:, c, None] + torch.cumsum(h, dim=1) - 1
        ri, ji = (h & (rank < cap)).nonzero(as_tuple=True)
        out[ri, :, rank[ri, ji]] = stacked[parent[ri].long(), :, ji]
        writes.index_put_((ri, rank[ri, ji]), torch.ones_like(ri, dtype=torch.int32),
                          accumulate=True)
        pad = (slots >= pad_lo[:, c, None]) & (slots < pad_hi[:, c, None])
        out = torch.where(pad[:, None, :], pads, out)
        writes += pad
    return Compaction(out, counts, chunk_hits, first, tested, writes)


_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 10 + [_I] * 7 + [ctypes.POINTER(ctypes.c_int)] * 2 + [
    ctypes.POINTER(ctypes.c_float), _I, _P]
# Per CUDA device index: (SMs, CTAs of the select kernel per SM).
_OCCUPANCY: dict[int, tuple[int, int]] = {}


def kernel_occupancy(device: torch.device) -> tuple[int, int]:
    """(SMs, CTAs per SM) of the select kernel on a CUDA device, queried
    once per device: the cooperative grid may hold at most their product.
    Raises where the device cannot launch cooperative kernels."""
    idx = device.index or 0
    if idx not in _OCCUPANCY:
        fn = native.function("select_values", "select_values_occupancy",
                             [_I, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)])
        ctas, sms = ctypes.c_int(), ctypes.c_int()
        native.check(fn(idx, ctypes.byref(ctas), ctypes.byref(sms)),
                     what="select_values_occupancy")
        _OCCUPANCY[idx] = (sms.value, ctas.value)
    return _OCCUPANCY[idx]


def _launch(rects, stacked, parent, pcnt, cap, pad_vals, box_idx, exact_idx):
    dev = stacked.device
    r = _check_rows(rects, stacked, parent, pcnt)
    _, n_chan, m = stacked.shape
    if n_chan > 32:
        raise ValueError(f"the kernel carries at most 32 channels, got {n_chan}")
    if stacked.data_ptr() % 16:
        stacked = stacked.clone()  # the kernel loads 4 candidates at a time, 16 bytes
    plan = chunk_plan(r, m, *kernel_occupancy(dev))
    out = torch.empty((r, n_chan, cap), dtype=torch.float32, device=dev)
    counts = torch.empty((r,), dtype=torch.int32, device=dev)
    scratch = torch.empty((plan.scratch,), dtype=torch.int32, device=dev)
    box = None if box_idx is None else (ctypes.c_int * 4)(*box_idx)
    exact = None if exact_idx is None else (ctypes.c_int * 13)(*exact_idx)
    pads = (ctypes.c_float * n_chan)(*pad_vals)
    fn = native.function("select_values", "select_values_launch", _ARGTYPES)
    native.launch(
        fn, stacked.data_ptr(), parent.data_ptr(), pcnt.data_ptr(),
        *(a.data_ptr() for a in rects), out.data_ptr(), counts.data_ptr(),
        scratch.data_ptr(), r, n_chan, m, cap, plan.ctas, plan.group, plan.ahead, box, exact,
        pads, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream, what="select_values")
    return out, counts


def _select(impl, row_rects, cand_channels, parent_of_row, cap, parent_counts,
            pad_vals, box_idx, exact_idx):
    rects, stacked, parent, pcnt, pad_vals = _prepare(
        row_rects, cand_channels, parent_of_row, cap, parent_counts, pad_vals, box_idx)
    if exact_idx is not None and len(exact_idx) != 13:
        raise ValueError("exact_idx needs 13 channel indices")
    return impl(rects, stacked, parent, pcnt, cap, pad_vals, box_idx, exact_idx)


def select_values(row_rects, cand_channels, parent_of_row, cap: int,
                  parent_counts=None, pad_vals=None, box_idx=(0, 1, 2, 3),
                  exact_idx: tuple | None = None):
    """Stream-compact candidate CHANNELS through per-row coverage tests.

    Args:
      row_rects: (rx0, rx1, ry0, ry1) each (R,) f32 — row rectangles
        (inclusive pixel bounds).
      cand_channels: a tuple of (NP, M) f32 tensors, or one stacked
        (NP, C, M) f32 tensor (e.g. a previous level's output). M is padded
        to a multiple of 1024 with pad_vals.
      parent_of_row: (R,) int — candidate list used by each row.
      cap: output capacity per row (multiple of 128).
      parent_counts: optional (R,) int — live candidates at the FRONT of
        each row's parent list; only whole 1024-candidate blocks up to it
        are walked, so every candidate past the count must never hit.
        None = walk all M candidates.
      pad_vals: per-channel fill past each row's count (default 0.0, with
        never-hit box fills at box_idx).
      box_idx: the 4 AABB channels (cx0, cx1, cy0, cy1) of the overlap
        test, or None for exact-only rows (pad_vals must then be never-hit
        under the exact test).
      exact_idx: when set, candidates must also pass the exact coverage
        test reading these 13 channels: r0..r8, fcx, fcy, te2, fr2.

    Returns (channels (R, C, cap) f32 compacted in candidate order,
    counts (R,) int32: TOTAL hits, which may exceed cap).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (csrc/select_values.cu) or raises."""
    dev = (cand_channels[0] if isinstance(cand_channels, (tuple, list))
           else cand_channels).device
    if dev.type == "cpu":
        impl = _plain
    elif dev.type == "cuda":
        impl = _launch
    else:
        raise ValueError(f"select_values runs on cpu or cuda, not {dev}")
    return _select(impl, row_rects, cand_channels, parent_of_row, cap,
                   parent_counts, pad_vals, box_idx, exact_idx)


def select_rows(row_rects, cand_boxes, parent_of_row, cap: int, parent_counts=None):
    """First-`cap` overlap positions per row, in candidate order.

    Position-returning wrapper over `select_values` (the select kernel on a
    CUDA tensor, its plain version on a CPU one): carries a per-parent
    iota channel through the compaction, so pos[r, j] indexes the parent's
    M axis. cand_boxes: the (cx0, cx1, cy0, cy1) (NP, M) f32 AABBs. Returns
    (pos (R, cap) int32, zero-filled past the count, and counts (R,) int32:
    TOTAL overlaps, which may exceed cap)."""
    np_, m = cand_boxes[0].shape
    g = torch.arange(m, dtype=torch.float32, device=cand_boxes[0].device)
    channels, counts = select_values(
        row_rects, tuple(cand_boxes) + (g[None, :].expand(np_, m),), parent_of_row, cap,
        parent_counts=parent_counts, pad_vals=BOX_PADS + (0.0,))
    return channels[:, 4].to(torch.int32), counts


def select_values_plain(row_rects, cand_channels, parent_of_row, cap: int,
                        parent_counts=None, pad_vals=None, box_idx=(0, 1, 2, 3),
                        exact_idx: tuple | None = None):
    """The plain PyTorch version of `select_values`, on any device."""
    return _select(_plain, row_rects, cand_channels, parent_of_row, cap,
                   parent_counts, pad_vals, box_idx, exact_idx)


def compaction_model(row_rects, cand_channels, parent_of_row, cap: int,
                     parent_counts=None, pad_vals=None, box_idx=(0, 1, 2, 3),
                     exact_idx: tuple | None = None) -> Compaction:
    """The select kernel's two-phase compaction in plain PyTorch, on any
    device, with `select_values`' arguments: each (row, chunk of CHUNK
    candidates) tests its slice of the walk and counts its hits (phase 1);
    then it writes its hits from its first rank on (the row's hits in
    earlier chunks), the ones below cap, and its share of the pad slots
    (phase 2). `out` and `counts` equal `select_values_plain`'s."""
    return _select(_model, row_rects, cand_channels, parent_of_row, cap, parent_counts,
                   pad_vals, box_idx, exact_idx)


# ---------------------------------------------------------------------------
# Count-only select: the same hit test, nothing carried.
# ---------------------------------------------------------------------------

_COUNT_ARGTYPES = [_P] * 8 + [_I] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2 + [_I, _P]
# Blocks the count kernel aims to keep in flight: a row is split over enough
# 256-thread blocks to give each of an H100's 132 SMs about four.
_COUNT_BLOCKS = 4 * 132


def _count_plain(rects, stacked, parent, pcnt, box_idx, exact_idx):
    hit = _walked_hits(rects, stacked, parent, pcnt, box_idx, exact_idx)
    return torch.sum(hit, dim=1, dtype=torch.int32)


def _count_launch(rects, stacked, parent, pcnt, box_idx, exact_idx):
    dev = stacked.device
    r = _check_rows(rects, stacked, parent, pcnt)
    _, n_chan, m = stacked.shape
    counts = torch.empty((r,), dtype=torch.int32, device=dev)  # the launcher zeroes it
    box = None if box_idx is None else (ctypes.c_int * 4)(*box_idx)
    exact = None if exact_idx is None else (ctypes.c_int * 13)(*exact_idx)
    splits = max(1, min(m // 256, -(-_COUNT_BLOCKS // max(r, 1))))
    fn = native.function("select_counts", "select_counts_launch", _COUNT_ARGTYPES)
    native.launch(
        fn, stacked.data_ptr(), parent.data_ptr(), pcnt.data_ptr(),
        *(a.data_ptr() for a in rects), counts.data_ptr(),
        r, n_chan, m, splits, box, exact, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream, what="select_counts")
    return counts


def _count(impl, row_rects, cand_channels, parent_of_row, parent_counts, pad_vals,
           box_idx, exact_idx):
    rects, stacked, parent, pcnt, _ = _prepare(
        row_rects, cand_channels, parent_of_row, LB, parent_counts, pad_vals, box_idx)
    if box_idx is None and exact_idx is None:
        raise ValueError("select_counts needs box_idx or exact_idx")
    if exact_idx is not None and len(exact_idx) != 13:
        raise ValueError("exact_idx needs 13 channel indices")
    return impl(rects, stacked, parent, pcnt, box_idx, exact_idx)


def select_counts(row_rects, cand_channels, parent_of_row, parent_counts=None,
                  pad_vals=None, box_idx=(0, 1, 2, 3), exact_idx: tuple | None = None):
    """Per-row TOTAL hit counts under the same tests and the same walk as
    `select_values`, without compacting anything: bit-equal to the counts
    `select_values` returns for the same arguments (which take no `cap`
    here). Returns (R,) int32.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (csrc/select_counts.cu, the counterpart of the TPU kernel
    `_count_kernel`) or raises."""
    dev = (cand_channels[0] if isinstance(cand_channels, (tuple, list))
           else cand_channels).device
    if dev.type == "cpu":
        impl = _count_plain
    elif dev.type == "cuda":
        impl = _count_launch
    else:
        raise ValueError(f"select_counts runs on cpu or cuda, not {dev}")
    return _count(impl, row_rects, cand_channels, parent_of_row, parent_counts,
                  pad_vals, box_idx, exact_idx)


def select_counts_plain(row_rects, cand_channels, parent_of_row, parent_counts=None,
                        pad_vals=None, box_idx=(0, 1, 2, 3),
                        exact_idx: tuple | None = None):
    """The plain PyTorch version of `select_counts`, on any device."""
    return _count(_count_plain, row_rects, cand_channels, parent_of_row, parent_counts,
                  pad_vals, box_idx, exact_idx)
