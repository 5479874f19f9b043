"""The chunked compaction's two-phase model against select_values_plain
on the other half of tests/torch_chunk_cases.py's cases
(tests/test_torch_select_chunks.py says what is held). Plain, on the
CPU; no JAX."""

import pytest

from test_torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)
from torch_chunk_cases import SECOND, check_model


@pytest.mark.parametrize("case", SECOND)
def test_model_matches_plain(case):
    """The two-phase model gives select_values_plain's bits, tests every
    walked candidate exactly once and writes every output slot once."""
    check_model(case)
