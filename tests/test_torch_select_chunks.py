"""The select kernel's chunked two-phase compaction, plain, on the CPU.

The kernel (csrc/select_values.cu) splits each row's walk into chunks of
one 1024-candidate macro block. Its CTAs take count and write work in one
fixed order (`work_at`): each (row, chunk) item first counts its hits and
adds one to its row's counter of counted chunks; later in the order, once
that counter shows every walked chunk of the row counted (a release /
acquire pair, no grid-wide barrier), the item writes its hits from its
first rank on (the row's hits in earlier chunks) and its share of the pad
slots. `select_kernel.compaction_model` is the two phases in plain
PyTorch, `chunk_plan` the grid the wrapper launches, and `work_order` and
`pad_slots` are Python copies of the kernel's `work_at` and its pad
formula. Here the model is held bit-equal to `select_values_plain`
(itself held against the JAX kernel in tests/test_torch_select.py) on
cases the level tests never reach, the plan is checked to test every
walked candidate once and write every output slot once, and the order to
put every row's writes after its counts. Imports no JAX and compiles
nothing; tests/test_torch_cuda.py runs the same cases through the kernel
on the card, over the full grid and over grids of a few CTAs.

The count-only kernel (csrc/select_counts.cu) takes the same (row, chunk)
items in chunk-major order with no order to keep: each walked item counts
its chunk and takes a ticket of its row, and the item that draws the last
ticket stores the row's sum. `select_kernel.count_plan`, `count_items` and
`count_model` are its grid, its order and its plain model, held here
against `select_counts_plain` on the same cases.
"""

import numpy as np
import pytest
import torch

from tpu2dgs_torch.raster import select_kernel as sk

CHUNK = sk.CHUNK
RECT = (0.0, 127.0, 0.0, 63.0)


def _rows(rects, parents, pcnt, dev):
    f32 = torch.float32
    return dict(row_rects=tuple(torch.tensor(a, dtype=f32, device=dev) for a in rects),
                parent_of_row=torch.tensor(parents, dtype=torch.int32, device=dev),
                parent_counts=torch.tensor(pcnt, dtype=torch.int32, device=dev))


def _random_boxes(dev, seed, n_parents, m, pcnt, cap, parents=None):
    """Box-only rows: random AABBs over an 800x800 screen, random 128x64
    row rectangles; candidate ids ride as a fifth channel."""
    rng = np.random.default_rng(seed)
    r = len(pcnt)
    x0 = rng.uniform(0, 800, (n_parents, m)).astype(np.float32)
    y0 = rng.uniform(0, 800, (n_parents, m)).astype(np.float32)
    x1 = x0 + rng.uniform(5, 300, (n_parents, m)).astype(np.float32)
    y1 = y0 + rng.uniform(5, 300, (n_parents, m)).astype(np.float32)
    ids = np.broadcast_to(np.arange(m, dtype=np.float32), (n_parents, m))
    rx0 = rng.uniform(0, 700, r).astype(np.float32)
    ry0 = rng.uniform(0, 700, r).astype(np.float32)
    if parents is None:
        parents = rng.integers(0, n_parents, r)
    chans = (x0, x1, y0, y1, np.ascontiguousarray(ids))
    return dict(cand_channels=tuple(torch.tensor(a, device=dev) for a in chans), cap=cap,
                **_rows((rx0, rx0 + 127, ry0, ry0 + 63), parents, pcnt, dev))


def _dense(dev, m, pcnt, cap):
    """One parent whose every candidate hits every row (distinct values)."""
    j = np.arange(m, dtype=np.float32)
    box = (np.zeros(m, np.float32), 10.0 + j, np.zeros(m, np.float32), 10.0 + 0.5 * j, j)
    r = len(pcnt)
    return dict(cand_channels=tuple(torch.tensor(a, device=dev)[None] for a in box), cap=cap,
                **_rows(tuple(np.full(r, v, np.float32) for v in RECT), [0] * r, pcnt, dev))


def _reaches_boundary(c, cap):
    return bool(((c.first_rank == cap) & (c.chunk_hits > 0)).any())


def _reaches_inside(c, cap):
    return bool(((c.first_rank < cap) & (c.first_rank + c.chunk_hits > cap)).any())


# name -> (device -> select_values kwargs of the case,
# what the case must reach in the model: (Compaction, cap) -> bool)
CASES = {
    # rows whose walk spans all 16 chunks, some over cap, some under
    "many_chunks": (lambda dev: _random_boxes(dev, 1, 2, 16384,
                                              [16384, 16384, 9000, 12000, 16383, 1], 1024),
                    lambda c, cap: bool(((c.chunk_hits > 0).sum(dim=1) >= 12).any())
                    and bool((c.counts > cap).any()) and bool((c.counts < cap).any())),
    "cap_inside_chunk": (lambda dev: _dense(dev, 4096, [4096, 3000], 1536),
                         _reaches_inside),
    "cap_on_chunk_boundary": (lambda dev: _dense(dev, 4096, [4096, 2048, 2049], 2048),
                              _reaches_boundary),
    "parent_count_zero": (lambda dev: _random_boxes(dev, 2, 2, 3072, [0, 0, 1500, 3072], 512),
                          lambda c, cap: bool((c.counts[:2] == 0).all())
                          and bool((c.chunk_hits[:2] == 0).all())),
    # one parent shared by 8 rows, walks cut at and around macro-block edges
    "shared_parent": (lambda dev: _random_boxes(dev, 3, 1, 8192,
                                                [0, 1, 1023, 1024, 1025, 4000, 8191, 8192],
                                                1024, parents=[0] * 8),
                      lambda c, cap: len(set(c.counts.tolist())) >= 5),
    # M = 5000 pads to 5 whole chunks, 5120 candidates: the full walk
    # tests the 120 pad candidates and none of them hits
    "m_padded": (lambda dev: _random_boxes(dev, 4, 2, 5000, [5000, 3000, 2048, 1025], 1024),
                 lambda c, cap: c.tested.shape[1] == 5 * CHUNK
                 and bool((c.tested[0, 5000:] == 1).all())),
    "overflow_in_first_chunk": (lambda dev: _dense(dev, 4096, [4096, 700], 128),
                                lambda c, cap: bool((c.chunk_hits[:, 0] > cap).all())),
    # walks of 32 chunks beside walks of one: a fixed split a row would wait
    # on the long rows
    "skewed_walks": (lambda dev: _random_boxes(dev, 5, 2, 32768,
                                               [32768, 1024, 1000, 32768, 1, 32000], 1024),
                     lambda c, cap: int(c.tested.sum(dim=1).max())
                     == 32 * int(c.tested.sum(dim=1).min())),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_plain(case):
    """The two-phase model gives select_values_plain's bits, tests every
    walked candidate exactly once and writes every output slot once."""
    build, reaches = CASES[case]
    kw = build("cpu")
    model = sk.compaction_model(**kw)
    ref, ref_cnt = sk.select_values_plain(**kw)
    cap = kw["cap"]
    assert reaches(model, cap), f"{case}: the case does not reach what it is for"
    assert torch.equal(model.counts, ref_cnt)
    assert torch.equal(model.out.view(torch.int32), ref.view(torch.int32))
    m = model.tested.shape[1]
    walk = sk._walked(kw["parent_counts"], m)
    walked = torch.arange(m)[None, :] < walk[:, None]
    assert torch.equal(model.tested, walked.to(torch.int32))
    assert bool((model.writes == 1).all())
    assert torch.equal(model.first_rank,
                       torch.cumsum(model.chunk_hits, dim=1) - model.chunk_hits)


PLANS = [
    (7, 131072, 896),     # L1 of the 800x800 bench scene: screen columns
    (91, 32768, 2912),    # L2: coarse bins
    (350, 8192, 2800),    # L3: tiles
    (3, 2048, 6),         # fewer items than the card holds CTAs
    (4, 5120, 20),        # M = 5000 padded to whole chunks
]


@pytest.mark.parametrize("rows, m, items", PLANS)
def test_chunk_plan(rows, m, items):
    """The grid comes from shapes alone: rows x M / CHUNK items, as many
    CTAs as the card holds (132 SMs x 2 CTAs) or as items; a group of
    rows gives every CTA an item."""
    plan = sk.chunk_plan(rows, m, 132, 2)
    assert plan.items == items == rows * plan.chunks
    assert plan.chunks * CHUNK == m
    assert plan.ctas == min(items, 264)
    assert plan.group == rows or plan.group * plan.chunks >= plan.ctas
    assert plan.ahead == plan.group * plan.chunks + plan.ctas
    assert plan.scratch == items * (1 + CHUNK // 16) + rows


@pytest.mark.parametrize("rows, m, items", PLANS)
def test_work_order(rows, m, items):
    """Every (row, chunk) item is counted once and written once, and every
    write of a row comes after all the row's counts, a wave of CTAs later
    where the row's group leaves room: no CTA waits on a later position."""
    plan = sk.chunk_plan(rows, m, 132, 2)
    kind, row, ch = sk.work_order(plan, rows)
    assert kind.shape == (plan.positions,)
    for k in (sk.COUNT, sk.WRITE):
        e = (row * plan.chunks + ch)[kind == k]
        assert torch.equal(torch.sort(e).values, torch.arange(items))
    pos = torch.arange(plan.positions)
    last_count = torch.full((rows,), -1).scatter_reduce(
        0, row[kind == sk.COUNT], pos[kind == sk.COUNT], "amax")
    first_write = torch.full((rows,), plan.positions).scatter_reduce(
        0, row[kind == sk.WRITE], pos[kind == sk.WRITE], "amin")
    lag = first_write - last_count
    assert bool((lag > 0).all())
    if plan.positions // 2 > plan.ahead:  # counts and writes interleave
        assert int(lag.min()) >= plan.ctas


def test_pad_slots_cover_once():
    """Every slot of [min(total, cap), cap) goes to exactly one chunk, no
    slot below it to any; the shares follow each other in chunk order and
    each but the first starts on 16 bytes."""
    g = torch.Generator().manual_seed(0)
    for cap, chunks in ((128, 1), (1536, 3), (2048, 8), (8192, 32), (32768, 128)):
        totals = torch.cat([torch.tensor([0, cap, cap - 1, 2 * cap]),
                            torch.randint(0, 2 * cap, (60,), generator=g)])
        lo, hi = sk.pad_slots(totals, cap, chunks)
        slots = torch.arange(cap)[None, None, :]
        share = (slots >= lo[:, :, None]) & (slots < hi[:, :, None])
        filled = torch.clamp(totals, max=cap)[:, None]
        assert torch.equal(share.sum(dim=1), (slots[0] >= filled).to(torch.int64))
        assert torch.equal(hi[:, :-1], lo[:, 1:]) and bool((hi >= lo).all())
        assert bool((lo[:, 1:] % 4 == 0)[hi[:, 1:] > lo[:, 1:]].all())


@pytest.mark.parametrize("case", sorted(CASES))
def test_count_model_matches_plain(case):
    """The count kernel's decomposition gives select_counts_plain's counts
    whatever order the items take their tickets in; every walked candidate
    is tested once, every row's count is stored by exactly one item (a row
    that walks nothing by its chunk 0), and every ticket ends at zero."""
    kw = CASES[case][0]("cpu")
    del kw["cap"]
    ref = sk.select_counts_plain(**kw)
    m = -(-kw["cand_channels"][0].shape[-1] // CHUNK) * CHUNK
    walk = sk._walked(kw["parent_counts"], m)
    walked = (torch.arange(m)[None, :] < walk[:, None]).to(torch.int32)
    assert bool((walk > CHUNK).any()), f"{case}: no row takes tickets"
    for finish in (None, torch.Generator().manual_seed(7)):
        model = sk.count_model(**kw, finish=finish)
        assert torch.equal(model.counts, ref)
        assert torch.equal(model.tested, walked)
        assert torch.equal(model.stores, torch.ones_like(model.stores))
        assert not bool(model.tickets.any())
        many = walk > CHUNK  # rows whose count is the sum of their item slots
        assert torch.equal(model.item_hits.sum(dim=1, dtype=torch.int32)[many], ref[many])


@pytest.mark.parametrize("rows, m, items", PLANS)
def test_count_plan(rows, m, items):
    """The count kernel's grid: rows x M / CHUNK items over as many CTAs as
    the card holds (132 SMs x 4 CTAs) or as items, one scratch slot an item
    and one ticket a row; the order takes every item once, chunk-major."""
    plan = sk.count_plan(rows, m, 132, 4)
    assert plan.items == items == rows * plan.chunks
    assert plan.chunks * CHUNK == m
    assert plan.ctas == min(items, 528)
    assert (plan.scratch, plan.tickets) == (items, rows)
    row, ch = sk.count_items(plan)
    assert torch.equal(torch.sort(row * plan.chunks + ch).values, torch.arange(items))
    assert bool((ch[:rows] == 0).all()) and bool((torch.diff(ch) >= 0).all())
