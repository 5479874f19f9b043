"""The other half of the resolution policy's cases
(tests/test_torch_data_formats.py's RESOLUTIONS): the port's
_target_resolution equal to the JAX package's."""

import pytest

from tests.test_torch_data_formats import RESOLUTIONS
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.data import scene as jscene
from tpu2dgs_torch.data import scene as tscene


@pytest.mark.parametrize("args", RESOLUTIONS[4:])
def test_resolution_policy_matches_jax(args):
    assert tscene._target_resolution(*args) == jscene._target_resolution(*args)
