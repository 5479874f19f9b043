"""Tile-row multi-device rendering (port of the tile-row half of
tpu2dgs/parallel/sharded.py).

`rasterize_sharded` splits the image's tile rows over the ranks of a
`Mesh` (parallel/distributed.py), one process per device. Every rank holds
every splat and preprocesses them all; then each

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

The backends' overflow counters are reduced over the ranks (`_reduce_aux`):
the worst strip's, and `_aux_strip_work` gathered into a (D,) vector.

A work window is rendered as a strip that starts at the coarse-bin row
holding the window's first row and ends with its last: the rank's buffers
hold its own rows and at most CBY - 1 tile rows before them, never the
full height (the JAX package renders a full-height grid on every device,
`sharded.py:189`). Its bins are the image grid's, so each tile's list is
the one the JAX package selects. The boundaries are read back to the host
once per render: they fix the strip's shapes.

Splat sharding (`rasterize_splat_sharded`, `shard_model_state`,
`segments > 1`, `xfer_capacity`) is the next multi-device slice.
"""

from __future__ import annotations

import torch

from tpu2dgs_torch.parallel import distributed
from tpu2dgs_torch.parallel.distributed import Mesh
from tpu2dgs_torch.raster import cuda_backend as cb
from tpu2dgs_torch.raster import tiled
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
        flat = distributed.all_reduce(ctx.mesh, flat)
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
        return distributed.all_gather(mesh, local).reshape(-1, *local.shape[1:])

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
        mesh, torch.stack([allmap[k].to(torch.float32).reshape(()) for k in keys]))
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


def _render_window(splats, settings, bg_color, mesh: Mesh, plain: bool):
    """This rank's work window: (its rows of the image and of the maps,
    padded to the largest window's; the maps' counters; the pixel-row
    indices that assemble the ranks' stacked windows; the rows of the
    strip it rendered them on)."""
    w, h = settings.width, settings.height
    n_dev, d = mesh.size, mesh.rank
    nty = -(-h // cb.BY)
    c = splats.box_center.detach()
    e = splats.box_half.detach()
    bnd = _balance_boundaries(c[:, 0] - e[:, 0], c[:, 0] + e[:, 0], c[:, 1] - e[:, 1],
                              c[:, 1] + e[:, 1], splats.visible, w, nty, n_dev,
                              tile_cap=settings.tile_capacity)
    b = bnd.tolist()  # the window fixes the strip's shapes
    lo, hi = b[d], b[d + 1]
    row0 = lo // cb.CBY * cb.CBY  # the coarse-bin row holding the window's first row
    img, allmap = cb.rasterize_cuda(splats, settings, bg_color, plain=plain, tile_row0=row0,
                                    nty_local=max(hi - row0, 1), row_lo=lo, row_hi=hi)
    dev_rows = max(b[k + 1] - b[k] for k in range(n_dev)) * cb.BY
    a, z = (lo - row0) * cb.BY, (hi - row0) * cb.BY

    def own(v):
        v = v[a:z]
        return torch.cat([v, v.new_zeros((dev_rows - v.shape[0], *v.shape[1:]))])

    maps = {k: v if k.startswith("_aux_") else own(v) for k, v in allmap.items()}
    return own(img), maps, _row_take(bnd, n_dev, h, dev_rows), img.shape[0]


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
        img, allmap, take, buffer_rows = _render_window(splats, settings, bg_color, mesh, plain)
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
    allmap["_aux_strip_rows"] = torch.tensor(float(buffer_rows), device=img.device)

    aux = _reduce_aux(allmap, mesh)
    image, maps = _gather_image(img, allmap, mesh, take)
    image = image[:h, :w]
    maps = {k: v[:h, :w] for k, v in maps.items()}
    maps.update(aux)  # the worst strip's capacity-overflow diagnostics
    return image, maps
