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
formula. Here and in tests/test_torch_select_chunks_model.py the model
is held bit-equal to `select_values_plain`
(itself held against the JAX kernel in tests/test_torch_select.py) on
cases the level tests never reach; tests/test_torch_select_chunks_plan.py
and tests/test_torch_select_chunks_order.py check the plan to test every
walked candidate once and write every output slot once, and the order to
put every row's writes after its counts. The cases are
tests/torch_chunk_cases.py's; the files import no JAX and compile
nothing, and tests/test_torch_cuda.py runs the same cases through the
kernel on the card, over the full grid and over grids of a few CTAs.

The count-only kernel (csrc/select_counts.cu) takes the same (row, chunk)
items in chunk-major order with no order to keep: each walked item counts
its chunk and takes a ticket of its row, and the item that draws the last
ticket stores the row's sum. `select_kernel.count_plan`, `count_items` and
`count_model` are its grid, its order and its plain model, held against
`select_counts_plain` on the same cases in
tests/test_torch_select_chunks_count*.py.
"""

import pytest
import torch

from test_torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)
from torch_chunk_cases import FIRST, check_model
from tpu2dgs_torch.raster import select_kernel as sk


@pytest.mark.parametrize("case", FIRST)
def test_model_matches_plain(case):
    """The two-phase model gives select_values_plain's bits, tests every
    walked candidate exactly once and writes every output slot once."""
    check_model(case)


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
