"""Multi-device rendering over the ranks of a `Mesh` (parallel/
distributed.py), one process per device: tile rows, and splats on top of
them (port of tpu2dgs/parallel/sharded.py).

`rasterize_sharded` splits the image's tile rows over the ranks. Every
rank holds every splat and preprocesses them all; then each

  * renders only its rows: a static strip (`rows_per` tile rows, a whole
    number of coarse-bin rows, at tile_row0 = rank * rows_per) or, with
    row_balance="work" on the cuda backend, a contiguous window of tile
    rows whose boundaries are quantiles of the per-row blend work;
  * gathers every rank's rows into the full image (`_GatherRows`), whose
    backward returns this rank's own rows of the image's cotangent: the
    loss downstream is computed alike on every rank, so each rank owns the
    cotangent of its rows and no communication is needed;
  * enters its rows' rasterization through `_Replicated`, identity forward,
    whose backward sums the splat cotangents over the ranks. That sum is
    what the transpose of JAX's shard_map does to the replicated splats:
    after it every rank holds the gradient of the whole image, the same as
    one device's, and computes the same parameter gradients and updates.

`rasterize_splat_sharded` ("gaussian parallelism", the scaling mode for
large scenes) also splits the splats: each rank holds its own contiguous
segment of the capacity axis, rows d*C/D .. (d+1)*C/D
(`shard_model_state`; `gather_model_state` puts the whole model back
together in one rank's host memory), so a splat's global id is
d * n_loc + its local row. Each rank

  * preprocesses and depth-compacts only its own splats, to its front-most
    k_loc survivors;
  * exchanges the survivors' records, depths and boxes: all-gathered
    (`_GatherRecords`, whose backward reduce-scatters the record
    cotangents to their owners) or, with settings.xfer_capacity > 0,
    routed by an all-to-all only to the strips their boxes cross
    (`_AllToAll`, its own transpose; a message past the capacity drops its
    deepest rows, counted by _aux_xfer_overflow_frac);
  * merges them into one device's front-to-back order: each rank's
    survivors come in (depth, local id) order and global ids grow with
    the rank, so one stable sort by depth of the rank-major concatenation
    gives (depth, global id) order, the single device's;
  * bins and blends its static strip, or its work window (boundaries from
    the merged boxes) on a strip of its own, with K1-K3 on the merged
    records, and gathers the rows as above.
Its per-splat outputs (radius, mean2d) are the rank's own rows, and the
gradients land on the rank's own parameter rows.

The backends' overflow counters are reduced over the ranks (`_reduce_aux`):
the worst strip's, and `_aux_strip_work` gathered into a (D,) vector.

A work window is rendered as a strip that starts at the coarse-bin row
holding the window's first row and ends with its last: the rank's buffers
hold its own rows and at most CBY - 1 tile rows before them, never the
full height (the JAX package renders a full-height grid on every device,
`sharded.py:189` and `:308`). Its bins are the image grid's, so each
tile's list is the one the JAX package selects. The boundaries are read
back to the host once per render: they fix the strip's shapes.
"""

from __future__ import annotations

import torch

from tpu2dgs_torch.model.optim import AdamState, init_adam
from tpu2dgs_torch.model.splats import STATS, SplatModel, SplatParams
from tpu2dgs_torch.parallel import distributed
from tpu2dgs_torch.parallel.distributed import Mesh
from tpu2dgs_torch.raster import binning, tiled
from tpu2dgs_torch.raster import cuda_backend as cb
from tpu2dgs_torch.raster import preprocess as pre
from tpu2dgs_torch.raster.preprocess import SplatScreen

# The splat-screen fields the backends differentiate through: the ones
# whose cotangents `_Replicated` sums over the ranks.
GRAD_FIELDS = ("tmat", "color", "opacity", "normal", "filter_center")


class _Replicated(torch.autograd.Function):
    """Identity on every rank's copy of the splats; the backward all-reduces
    (sums) the cotangents, in one collective."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        ctx.shapes = [x.shape for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        flat = distributed.all_reduce(ctx.mesh, flat, part="gradients")
        out, at = [], 0
        for shape in ctx.shapes:
            k = shape.numel()
            out.append(flat[at:at + k].view(shape))
            at += k
        return (None, *out)


def replicated(splats: SplatScreen, mesh: Mesh) -> SplatScreen:
    """The splats with the rank-summing backward on the fields that carry
    gradients (a no-op for fields that do not require grad)."""
    names = [f for f in GRAD_FIELDS if getattr(splats, f).requires_grad]
    if not names:
        return splats
    outs = _Replicated.apply(mesh, *(getattr(splats, f) for f in names))
    return splats._replace(**dict(zip(names, outs)))


class _GatherRows(torch.autograd.Function):
    """(rows, W, C) on each rank -> (size * rows, W, C), the ranks' rows in
    rank order; the backward takes this rank's rows of the cotangent."""

    @staticmethod
    def forward(ctx, local, mesh):
        ctx.rank, ctx.rows = mesh.rank, local.shape[0]
        return distributed.all_gather(mesh, local, part="assembly").reshape(-1, *local.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.rows
        return grad[lo:lo + ctx.rows], None


# Per-rank counters gathered into (D,) vectors rather than reduced.
PER_RANK = ("_aux_strip_work", "_aux_strip_rows")


def _reduce_aux(allmap: dict, mesh: Mesh) -> dict:
    """The _aux_* scalars over the ranks, in one gather: the worst strip's
    (max) for each, and the PER_RANK ones as (D,) vectors: _aux_strip_work,
    the entries each rank blended (its max/mean is the tile-row split's
    efficiency bound), and _aux_strip_rows, the pixel rows of each rank's
    render buffers."""
    keys = sorted(k for k in allmap if k.startswith("_aux_"))
    if not keys:
        return {}
    every = distributed.all_gather(
        mesh, torch.stack([allmap[k].to(torch.float32).reshape(()) for k in keys]),
        part="assembly")
    return {k: every[:, i] if k in PER_RANK else torch.amax(every[:, i])
            for i, k in enumerate(keys)}


def _strip_rows(height: int, tile_px: int, coarse_tiles: int, n_dev: int) -> int:
    """Tile rows per device, rounded up to a whole number of coarse-bin rows."""
    nty = -(-height // tile_px)
    per = -(-nty // n_dev)
    return -(-per // coarse_tiles) * coarse_tiles


def _balance_boundaries(x0, x1, y0, y1, vis, w: int, nty: int, n_dev: int,
                        tile_cap: int = 1 << 30) -> torch.Tensor:
    """Work-quantile tile-row window boundaries for D devices.

    x0..y1: (K,) f32 screen AABBs (culled entries have lo > hi). The work
    proxy is the per-tile blend-entry count clamped at the tile capacity:
    a (nty+1, nbx+1) 2D difference histogram (4 corner adds per splat and a
    2D cumsum), clamped per tile, summed over columns. Boundaries are
    quantiles of the row-work prefix sum, so device d's window
    [b[d], b[d+1]) carries about 1/D of the total entries. The counts are
    integers here, which the JAX package's float32 ones equal below 2^24;
    the quantile arithmetic is its float32.

    Returns b: (n_dev+1,) int32, b[0] = 0, b[n_dev] = nty."""
    dev = x0.device
    nbx = -(-w // cb.BX)

    def cell(v, size, n):
        return torch.clamp(torch.floor(v / size), 0, n - 1)

    c0, c1 = cell(x0, cb.BX, nbx), cell(x1, cb.BX, nbx)
    r0, r1 = cell(y0, cb.BY, nty), cell(y1, cb.BY, nty)
    valid = (x0 <= x1) & (y0 <= y1) & vis
    one = valid.to(torch.int64)
    # a culled splat adds 0: keep its (possibly non-finite) index in range
    c0, c1, r0, r1 = (torch.where(valid, c, 0.0).to(torch.int64) for c in (c0, c1, r0, r1))
    ncol = nbx + 1
    flat = torch.zeros(((nty + 1) * ncol,), dtype=torch.int64, device=dev)
    flat.index_add_(0, r0 * ncol + c0, one)
    flat.index_add_(0, r0 * ncol + c1 + 1, -one)
    flat.index_add_(0, (r1 + 1) * ncol + c0, -one)
    flat.index_add_(0, (r1 + 1) * ncol + c1 + 1, one)
    tiles = torch.cumsum(torch.cumsum(flat.reshape(nty + 1, ncol), 0), 1)[:nty, :nbx]
    row_work = torch.sum(torch.clamp(tiles, max=tile_cap), dim=1)
    prefix = torch.cumsum(row_work, 0).to(torch.float32)
    total = prefix[-1]
    targets = torch.arange(1, n_dev, dtype=torch.float32, device=dev) * (total / n_dev)
    mids = torch.searchsorted(prefix, targets, side="left") + 1
    return torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev), mids,
                      torch.full((1,), nty, dtype=torch.int64, device=dev)]).to(torch.int32)


def _row_take(b, n_dev: int, h: int, dev_rows: int) -> torch.Tensor:
    """Pixel-row gather indices reassembling D stacked windows (rank-major,
    dev_rows pixel rows each, window d's first row at its offset 0) into
    the image: pixel row i comes from the rank whose window holds tile row
    i // BY, at its offset from that window's first pixel row."""
    b = b.to(torch.int64)
    i = torch.arange(h, dtype=torch.int64, device=b.device)
    d = torch.searchsorted(b[1:n_dev], i // cb.BY, right=True)
    return d * dev_rows + i - b[d] * cb.BY


def _map_channels(image, allmap):
    """(rows, W, C) of the image and every per-pixel map, and how to split
    it back: [(key, channels)]."""
    names = [("image", image)] + [(k, v) for k, v in allmap.items() if not k.startswith("_aux_")]
    parts = [v if v.dim() == 3 else v[..., None] for _, v in names]
    layout = [(k, v.shape[2] if v.dim() == 3 else 0) for k, v in names]
    return torch.cat(parts, dim=-1), layout


def _split_channels(stacked, layout):
    out, at = {}, 0
    for k, c in layout:
        out[k] = stacked[..., at:at + c] if c else stacked[..., at]
        at += max(c, 1)
    return out


def _gather_image(local, allmap, mesh: Mesh, take=None):
    """The full-height (image, maps) from every rank's rows: `local` and
    the maps of `allmap` hold this rank's rows (padded alike on every
    rank); `take`, when given, picks the image's pixel rows out of the
    rank-major stack."""
    stacked, layout = _map_channels(local, allmap)
    every = _GatherRows.apply(stacked, mesh)
    if take is not None:
        every = every[take]
    maps = _split_channels(every, layout)
    return maps.pop("image"), maps


def _render_window(bnd, mesh: Mesh, h: int, render_strip):
    """This rank's work window of the boundaries `bnd` ((D+1,) image tile
    rows), rendered by render_strip(tile_row0, nty_local, row_lo, row_hi)
    -> (image, allmap) on the strip from the coarse-bin row that holds the
    window's first row. Returns (its rows of the image and of the maps,
    padded to the largest window's; the maps' counters; the pixel-row
    indices that assemble the ranks' stacked windows; the rows of the
    strip it rendered them on)."""
    n_dev, d = mesh.size, mesh.rank
    b = bnd.tolist()  # the window fixes the strip's shapes
    lo, hi = b[d], b[d + 1]
    row0 = lo // cb.CBY * cb.CBY  # the coarse-bin row holding the window's first row
    img, allmap = render_strip(row0, max(hi - row0, 1), lo, hi)
    dev_rows = max(b[k + 1] - b[k] for k in range(n_dev)) * cb.BY
    a, z = (lo - row0) * cb.BY, (hi - row0) * cb.BY

    def own(v):
        v = v[a:z]
        return torch.cat([v, v.new_zeros((dev_rows - v.shape[0], *v.shape[1:]))])

    maps = {k: v if k.startswith("_aux_") else own(v) for k, v in allmap.items()}
    return own(img), maps, _row_take(bnd, n_dev, h, dev_rows), img.shape[0]


def _assemble(img, allmap, mesh: Mesh, settings, take, buffer_rows: int):
    """(image (H, W, 3), allmap) on every rank from every rank's rows: the
    maps full height, the _aux_* counters reduced over the ranks."""
    allmap["_aux_strip_rows"] = torch.tensor(float(buffer_rows), device=img.device)
    aux = _reduce_aux(allmap, mesh)
    image, maps = _gather_image(img, allmap, mesh, take)
    w, h = settings.width, settings.height
    maps = {k: v[:h, :w] for k, v in maps.items()}
    maps.update(aux)  # the worst strip's capacity-overflow diagnostics
    return image[:h, :w], maps


def rasterize_sharded(splats: SplatScreen, settings, bg_color: torch.Tensor, mesh: Mesh,
                      plain: bool = False):
    """Row-sharded rendering: each rank rasterizes its tile rows with the
    backend the settings select (the cuda kernels, their plain versions
    with `plain=True`, or the tiled backend). Returns (image (H, W, 3),
    allmap) on every rank, the maps full height and the _aux_* counters
    reduced over the ranks."""
    w, h = settings.width, settings.height
    n_dev, d = mesh.size, mesh.rank
    splats = replicated(splats, mesh)
    take = None
    if settings.backend == "cuda" and settings.row_balance == "work" and n_dev > 1:
        nty = -(-h // cb.BY)
        c = splats.box_center.detach()
        e = splats.box_half.detach()
        bnd = _balance_boundaries(c[:, 0] - e[:, 0], c[:, 0] + e[:, 0], c[:, 1] - e[:, 1],
                                  c[:, 1] + e[:, 1], splats.visible, w, nty, n_dev,
                                  tile_cap=settings.tile_capacity)

        def strip(row0, nty_local, lo, hi):
            return cb.rasterize_cuda(splats, settings, bg_color, plain=plain, tile_row0=row0,
                                     nty_local=nty_local, row_lo=lo, row_hi=hi)

        img, allmap, take, buffer_rows = _render_window(bnd, mesh, h, strip)
    else:
        if settings.backend == "cuda":  # strips of whole coarse-bin rows
            rows_per = _strip_rows(h, cb.BY, cb.CBY, n_dev)
            img, allmap = cb.rasterize_cuda(splats, settings, bg_color, plain=plain,
                                            tile_row0=d * rows_per, nty_local=rows_per)
        else:
            rows_per = _strip_rows(h, settings.tile_px, settings.coarse_tiles, n_dev)
            img, allmap = tiled.rasterize_rows(splats, settings, bg_color, d * rows_per,
                                               rows_per)
        buffer_rows = img.shape[0]
    return _assemble(img, allmap, mesh, settings, take, buffer_rows)


# ---------------------------------------------------------------------------
# Splat sharding
# ---------------------------------------------------------------------------


def shard_model_state(model: SplatModel, adam: AdamState | None, mesh: Mesh):
    """(model, adam): this rank's segment of the whole `model` and of its
    Adam state (None: fresh moments for the segment), rows rank*C/D ..
    (rank+1)*C/D of every per-splat tensor: parameters, live mask,
    densification statistics and moments, on the rank's device, so each
    rank keeps 1/D of them (JAX's P("rows") layout). The whole model may
    lie in host memory."""
    c = model.capacity
    if c % mesh.size:
        raise ValueError(f"splat sharding needs capacity divisible by the mesh: {c} % "
                         f"{mesh.size} != 0 (grow the model capacity)")
    per = c // mesh.size
    sl = slice(mesh.rank * per, (mesh.rank + 1) * per)

    def own(a):
        return a.detach()[sl].to(mesh.device, copy=True)

    part = SplatModel(SplatParams(*(own(a) for a in model.params)), own(model.live),
                      *(own(getattr(model, k)) for k in STATS))
    if adam is None:
        return part, init_adam(part.params)
    return part, AdamState(adam.count, SplatParams(*(own(a) for a in adam.mu)),
                           SplatParams(*(own(a) for a in adam.nu)))


def gather_model_state(model: SplatModel, adam: AdamState, mesh: Mesh, dst: int = 0):
    """(model, adam): the whole model and Adam state, in host memory on
    rank `dst`, from every rank's segment in rank order; (None, None) on
    the other ranks. A collective, every rank calls it: each rank's tensors
    as one float32 vector, sent to `dst` one rank at a time
    (`distributed.gather_to_host`), so no device holds the whole model."""
    tensors = [*model.params, *(getattr(model, k) for k in STATS), model.live,
               *adam.mu, *adam.nu]
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
    every = distributed.gather_to_host(mesh, flat, dst)
    del flat
    if every is None:
        return None, None
    whole, at = [], 0
    for t in tensors:
        k = t.numel()
        whole.append(torch.cat([seg[at:at + k].reshape(t.shape) for seg in every])
                     .to(t.dtype))
        at += k
    n, s = len(SplatParams._fields), len(STATS)
    model = SplatModel(SplatParams(*whole[:n]), whole[n + s], *whole[n:n + s])
    moments = whole[n + s + 1:]
    return model, AdamState(adam.count, SplatParams(*moments[:n]), SplatParams(*moments[n:]))


class _GatherRecords(torch.autograd.Function):
    """(k, C) rows on each rank -> (size * k, C), every rank's in rank
    order. The backward reduce-scatters the cotangent: each rank's rows get
    the sum over the ranks of theirs, the transpose of the all-gather."""

    @staticmethod
    def forward(ctx, rows, mesh):
        ctx.mesh = mesh
        return distributed.all_gather(mesh, rows, part="exchange").reshape(-1, rows.shape[1])

    @staticmethod
    def backward(ctx, grad):
        return distributed.reduce_scatter(ctx.mesh, grad.contiguous(), part="exchange"), None


class _AllToAll(torch.autograd.Function):
    """(size, k, C) messages, block s for rank s -> (size, k, C), block s
    from rank s. Its own transpose: the backward sends each cotangent back
    to the rank that sent the row."""

    @staticmethod
    def forward(ctx, msgs, mesh):
        ctx.mesh = mesh
        return distributed.all_to_all(mesh, msgs, part="exchange")

    @staticmethod
    def backward(ctx, grad):
        return distributed.all_to_all(ctx.mesh, grad.contiguous(), part="exchange"), None


def _routed(rec_loc, meta, comp, mesh: Mesh, settings, k_loc: int, nty: int, rows_per: int,
            balanced: bool, cap: int):
    """The strip-routed exchange: this rank sends each strip the first
    xfer rows (in its depth order) whose boxes cross the strip's pixel
    rows. Returns (received records (D * kx, REC), their meta (D * kx, 3),
    the strips' boundaries (D+1,) image tile rows, the xfer counters)."""
    n_dev = mesh.size
    kx = cb._round128(min(settings.xfer_capacity, k_loc))
    if balanced:
        # windows from every rank's survivor boxes, the merged set
        boxes = distributed.all_gather(mesh, meta[:, 1:], part="exchange")
        boxes = boxes.reshape(-1, 2).to(torch.int64)
        gx0, gx1 = binning.unpack_interval(boxes[:, 0])
        gy0, gy1 = binning.unpack_interval(boxes[:, 1])
        bnd = _balance_boundaries(gx0, gx1, gy0, gy1, torch.ones_like(gx0, dtype=torch.bool),
                                  settings.width, nty, n_dev, tile_cap=cap)
    else:
        bnd = torch.clamp(torch.arange(n_dev + 1, device=meta.device) * rows_per,
                          max=nty).to(torch.int32)
    blo = (bnd[:-1] * cb.BY).to(torch.float32)
    bhi = (bnd[1:] * cb.BY).to(torch.float32) - 1.0
    hit = ((comp.y0[None, :] <= bhi[:, None]) & (comp.y1[None, :] >= blo[:, None])
           & comp.valid[None, :])                                   # (D, k_loc)
    pos, vx, cnts = binning.first_k_hits(hit, kx)                   # (D, kx)
    # A message's rows past its hits are never binned; masked here, they
    # carry no cotangent back into rec_loc either.
    rec_out = torch.where(vx[..., None], rec_loc[pos], 0.0)
    nohit = float(binning.pack_interval(torch.tensor(1e9), torch.tensor(-1e9)))
    empty = meta.new_tensor([torch.inf, nohit, nohit])
    meta_out = torch.where(vx[..., None], meta[pos], empty)
    f32 = torch.float32
    aux = {
        # the share of this rank's D messages that overflowed (their
        # deepest rows dropped), and the largest demand, for the Trainer
        "_aux_xfer_overflow_frac": torch.mean((cnts > kx).to(f32)),
        "_aux_xfer_count_max": torch.amax(cnts).to(f32),
    }
    return (_AllToAll.apply(rec_out, mesh).reshape(-1, cb.REC),
            distributed.all_to_all(mesh, meta_out, part="exchange").reshape(-1, 3), bnd, aux)


def rasterize_splat_sharded(cam, settings, xyz, scaling, rotation, opacity, features,
                            bg_color: torch.Tensor, mesh: Mesh, mean2d_offset=None, live=None,
                            override_color=None, axes_override=None, plain: bool = False):
    """Splat-sharded rendering on the cuda backend (its plain versions with
    `plain=True`): every argument that holds a row per splat holds this
    rank's segment of the rows, n_loc of them, the same on every rank.
    Returns (image (H, W, 3), allmap, radius (n_loc,), mean2d (n_loc, 2)):
    the image and the maps whole on every rank, the counters reduced over
    the ranks, the per-splat outputs this rank's rows."""
    w, h = settings.width, settings.height
    n_dev, d = mesh.size, mesh.rank
    n_loc = xyz.shape[0]
    n = n_loc * n_dev
    # Capacities from the global count, as one device derives them.
    k_vis = min(settings.vis_capacity or n, n)
    # Each rank keeps ITS front-most k_loc survivors (ceil(k_vis / D),
    # 128-rounded), not the global front-most k_vis; _aux_vis_overflow
    # flags a rank that lost any.
    k_loc = min(n_loc, cb._round128(-(-k_vis // n_dev)))
    if n_dev * k_loc >= 1 << 24:
        # merged survivor slots ride an f32 channel through binning
        raise ValueError(f"splat sharding: merged survivor count {n_dev * k_loc} >= 2^24 "
                         f"exceeds the f32 slot channel; set vis_capacity < {1 << 24}")
    nbx = -(-w // cb.BX)
    nty = -(-h // cb.BY)
    balanced = settings.row_balance == "work" and n_dev > 1
    rows_per = _strip_rows(h, cb.BY, cb.CBY, n_dev)
    cap = min(settings.tile_capacity, max(n, 1))
    bin_cap = max(min(settings.bin_capacity, max(n, 1)), cap)

    splats = pre.preprocess(
        xyz, scaling, rotation, opacity, features, cam, w, h, settings.sh_degree,
        mean2d_offset=mean2d_offset, scale_modifier=settings.scale_modifier, live=live,
        override_color=override_color, axes_override=axes_override)
    comp = binning.compact_visible(splats, k_loc)
    rec_loc = cb.pack_records(splats)[comp.perm.to(torch.int64)]    # (k_loc, REC)
    # Depth (+inf past the survivors) and the packed boxes (< 2^32) ride
    # one float64 tensor, exactly.
    meta = torch.stack([comp.depth.to(torch.float64),
                        binning.pack_interval(comp.x0, comp.x1).to(torch.float64),
                        binning.pack_interval(comp.y0, comp.y1).to(torch.float64)], dim=1)
    if settings.xfer_capacity:
        rec_m, meta_m, bnd, aux = _routed(rec_loc, meta, comp, mesh, settings, k_loc, nty,
                                          rows_per, balanced, cap)
    else:
        rec_m = _GatherRecords.apply(rec_loc, mesh)
        meta_m = distributed.all_gather(mesh, meta, part="exchange").reshape(-1, 3)
        bnd, aux = None, {}
    order = torch.sort(meta_m[:, 0], stable=True).indices  # (depth, global id)
    rec_c = rec_m[order]
    sx0, sx1 = binning.unpack_interval(meta_m[order, 1].to(torch.int64))
    sy0, sy1 = binning.unpack_interval(meta_m[order, 2].to(torch.int64))
    n_vis = torch.sum(torch.isfinite(meta_m[:, 0]))  # the survivors that arrived
    if balanced and bnd is None:
        bnd = _balance_boundaries(sx0, sx1, sy0, sy1, torch.ones_like(sx0, dtype=torch.bool),
                                  w, nty, n_dev, tile_cap=cap)

    def strip(row0, nty_local, lo=None, hi=None):
        return cb.bin_and_blend(sx0, sx1, sy0, sy1, n_vis, comp.num_visible > k_loc, rec_c,
                                settings, bg_color, nbx, nty_local, bin_cap, cap, aux=aux,
                                plain=plain, tile_row0=row0, full=False, row_lo=lo, row_hi=hi)

    take = None
    if balanced:
        img, allmap, take, buffer_rows = _render_window(bnd, mesh, h, strip)
    else:
        img, allmap = strip(d * rows_per, rows_per)
        buffer_rows = img.shape[0]
    image, allmap = _assemble(img, allmap, mesh, settings, take, buffer_rows)
    return image, allmap, splats.radius, splats.mean2d
