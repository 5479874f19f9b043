"""The cases of the select kernels' chunked compaction and count, shared
by tests/test_torch_select_chunks*.py (plain, on the CPU) and
tests/test_torch_cuda.py (through the kernels, on the card). It holds no
tests and imports no JAX: the test files import it as
`torch_chunk_cases` (tests/ is on sys.path), which works on the card
under `--noconftest` too, where `tests` may name another installed
package.

`CASES` maps a name to the select_values keywords of a case and to what
the case must reach in `compaction_model`; `PLANS` are grid shapes.
`check_model` and `check_count_model` are the bodies of
test_model_matches_plain and test_count_model_matches_plain, whose cases
lie over two files each (`FIRST` and `SECOND`), six items or fewer a file.
"""

import numpy as np
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

FIRST, SECOND = sorted(CASES)[:4], sorted(CASES)[4:]

PLANS = [
    (7, 131072, 896),     # L1 of the 800x800 bench scene: screen columns
    (91, 32768, 2912),    # L2: coarse bins
    (350, 8192, 2800),    # L3: tiles
    (3, 2048, 6),         # fewer items than the card holds CTAs
    (4, 5120, 20),        # M = 5000 padded to whole chunks
]


def check_model(case):
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


def check_count_model(case):
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
