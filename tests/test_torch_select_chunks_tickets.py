"""The count kernel's plain model (`select_kernel.count_model`) against
select_counts_plain on the second half of tests/torch_chunk_cases.py's
cases, whatever order the items draw their row's tickets in
(tests/test_torch_select_chunks.py says what is held). Plain, on the
CPU; no JAX."""

import pytest

from test_torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)
from torch_chunk_cases import SECOND, check_count_model


@pytest.mark.parametrize("case", SECOND)
def test_count_model_matches_plain(case):
    """The count kernel's decomposition gives select_counts_plain's counts
    whatever order the items take their tickets in; every walked candidate
    is tested once, every row's count is stored by exactly one item (a row
    that walks nothing by its chunk 0), and every ticket ends at zero."""
    check_count_model(case)
