"""The select kernel's grid (`select_kernel.chunk_plan`) from shapes
alone, at tests/torch_chunk_cases.py's plans. Plain, on the CPU; no
JAX."""

import pytest

from test_torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)
from torch_chunk_cases import PLANS
from tpu2dgs_torch.raster import select_kernel as sk

CHUNK = sk.CHUNK


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
