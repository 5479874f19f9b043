"""The select kernel's work order (`select_kernel.work_order`, a copy
of the kernel's `work_at`) at tests/torch_chunk_cases.py's plans: every
row's writes after its counts. Plain, on the CPU; no JAX."""

import pytest
import torch

from test_torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)
from torch_chunk_cases import PLANS
from tpu2dgs_torch.raster import select_kernel as sk


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
