"""The count kernel's grid and item order (`select_kernel.count_plan`,
`count_items`) at tests/torch_chunk_cases.py's plans. Plain, on the
CPU; no JAX."""

import pytest
import torch

from test_torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)
from torch_chunk_cases import PLANS
from tpu2dgs_torch.raster import select_kernel as sk

CHUNK = sk.CHUNK


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
