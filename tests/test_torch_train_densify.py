"""tpu2dgs_torch's densify_and_prune (the same split noise handed to both
packages; one and two segments) and reset_opacity against tpu2dgs's, on
the models of tests/test_torch_train_model.py. Tolerances as
tests/test_torch_train.py states them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_core import to_torch
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_train import FIELDS, _np
from tests.test_torch_train_model import _assert_same_model, _stats_pair
from tpu2dgs.model import densify as jdensify
from tpu2dgs.model import optim as joptim
from tpu2dgs_torch.model import densify as tdensify
from tpu2dgs_torch.model import optim as toptim
from tpu2dgs_torch.model import splats as tsplats


@pytest.mark.parametrize("case", ["room", "full", "size_prune"])
def test_densify_and_prune_matches_jax(case):
    c = 128  # one shape: the JAX function compiles once for the three cases
    tm, jm = _stats_pair(seed=4, n=120 if case == "full" else 40, c=c)
    # a spread of scales around percent_dense * extent, some low opacities
    rng = np.random.default_rng(5)
    scaling = rng.uniform(-4.5, -2.0, (c, 2)).astype(np.float32)
    opacity = rng.uniform(-4.0, 3.0, (c, 1)).astype(np.float32)
    jm = jm._replace(params=jm.params._replace(scaling=jnp.asarray(scaling),
                                              opacity=jnp.asarray(opacity)))
    with torch.no_grad():
        tm.scaling.copy_(to_torch(scaling))
        tm.opacity.copy_(to_torch(opacity))
    aj, at = joptim.init_adam(jm.params), toptim.init_adam(tm.params)
    aj = aj._replace(mu=jax.tree.map(lambda a: a + 1.0, aj.mu),
                     nu=jax.tree.map(lambda a: a + 2.0, aj.nu))
    for a in at.mu:
        a += 1.0
    for a in at.nu:
        a += 2.0
    key = jax.random.PRNGKey(9)
    eps = np.asarray(jax.random.normal(key, (2, c, 2), jnp.float32))
    use_size = case == "size_prune"
    # the port changes the moments in place: a copy for the segmented round
    at_seg = toptim.AdamState(at.count, *(tsplats.SplatParams(*(a.clone() for a in m))
                                          for m in (at.mu, at.nu)))
    jm2, aj2, ij = jdensify.densify_and_prune(jdensify.DensifyConfig(), jm, aj, key, 3.0, use_size)
    tm2, at2, it = tdensify.densify_and_prune(tdensify.DensifyConfig(), tm, at, None, 3.0,
                                              use_size, eps=to_torch(eps))
    for k in ij._fields:
        assert int(getattr(it, k)) == int(getattr(ij, k)), k
    assert int(it.num_cloned) > 0 and int(it.num_split) > 0 and int(it.num_pruned) > 0
    assert (int(it.num_dropped) > 0) == (case == "full")
    _assert_same_model(tm2, jm2)
    for name in FIELDS:
        np.testing.assert_array_equal(_np(getattr(at2.mu, name)), _np(getattr(aj2.mu, name)))
        np.testing.assert_array_equal(_np(getattr(at2.nu, name)), _np(getattr(aj2.nu, name)))
    # two segments, each compacting its children into its own free slots
    jm3, aj3, ij3 = jdensify.densify_and_prune(jdensify.DensifyConfig(), jm, aj, key, 3.0,
                                               use_size, segments=2)
    tm3, at3, it3 = tdensify.densify_and_prune(tdensify.DensifyConfig(), tm, at_seg, None,
                                               3.0, use_size, segments=2, eps=to_torch(eps))
    for k in ij3._fields:
        assert int(getattr(it3, k)) == int(getattr(ij3, k)), k
    _assert_same_model(tm3, jm3)
    for name in FIELDS:
        np.testing.assert_array_equal(_np(getattr(at3.mu, name)), _np(getattr(aj3.mu, name)))
        np.testing.assert_array_equal(_np(getattr(at3.nu, name)), _np(getattr(aj3.nu, name)))
    # drawing the noise from a generator is reproducible from its seed
    runs = [tdensify.densify_and_prune(tdensify.DensifyConfig(), tm, at,
                                       torch.Generator().manual_seed(1), 3.0, False)[0]
            for _ in range(2)]
    assert torch.equal(runs[0].xyz, runs[1].xyz)


def test_reset_opacity_matches_jax():
    tm, jm = _stats_pair(seed=6)
    aj, at = joptim.init_adam(jm.params), toptim.init_adam(tm.params)
    aj = aj._replace(mu=jax.tree.map(lambda a: a + 1.0, aj.mu))
    for a in at.mu:
        a += 1.0
    jm2, aj2 = jdensify.reset_opacity(jm, aj)
    tm2, at2 = tdensify.reset_opacity(tm, at)
    _assert_same_model(tm2, jm2)
    assert float(at2.mu.opacity.abs().max()) == 0.0 and float(at2.mu.xyz.min()) == 1.0
    np.testing.assert_array_equal(_np(at2.mu.opacity), _np(aj2.mu.opacity))
