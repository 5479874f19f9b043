"""tpu2dgs_torch's model utilities for training against tpu2dgs's, on the
same numpy inputs: the exact 3-NN scale initialisation, create_from_pcd
and grow_capacity (one and two segments), the densification statistics
(add_stats), and the conversion of the whole training state both ways.
Tolerances as tests/test_torch_train.py states them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_core import to_torch
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_train import FIELDS, _close, _np
from tpu2dgs.model import densify as jdensify
from tpu2dgs.model import knn as jknn
from tpu2dgs.model import optim as joptim
from tpu2dgs.model import splats as jsplats
from tpu2dgs_torch.model import convert
from tpu2dgs_torch.model import densify as tdensify
from tpu2dgs_torch.model import knn as tknn
from tpu2dgs_torch.model import splats as tsplats


# -- model ------------------------------------------------------------------

@pytest.mark.parametrize("n", [5, 700, 2500])
def test_knn_matches_jax(n):
    pts = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    got = tknn.mean_dist2_to_3nn(to_torch(pts), row_block=512, col_chunk=1024)
    _close(got, jknn.mean_dist2_to_3nn(jnp.asarray(pts)), 1e-6)


def _assert_same_model(tm, jm, tol=1e-6):
    for name in FIELDS:
        _close(getattr(tm, name), getattr(jm.params, name), tol, name)
    np.testing.assert_array_equal(_np(tm.live), _np(jm.live))
    for name in tsplats.STATS:
        _close(getattr(tm, name), getattr(jm, name), tol, name)


def _pcd(n=40, seed=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)).astype(np.float32), rng.uniform(size=(n, 3)).astype(np.float32)


def test_create_from_pcd_and_grow_capacity_match_jax():
    pts, rgb = _pcd()
    jm = jsplats.create_from_pcd(pts, rgb, capacity=64)
    tm = tsplats.create_from_pcd(pts, rgb, capacity=64, device="cpu")
    _assert_same_model(tm, jm)
    assert tsplats.create_from_pcd(pts, rgb, device="cpu").capacity == 4096
    jm = jm._replace(grad_accum=jm.grad_accum.at[:40].set(0.5), denom=jm.denom + 2.0)
    tm.grad_accum[:40] = 0.5
    tm.denom += 2.0
    tg = tsplats.grow_capacity(tm, 96)
    _assert_same_model(tg, jsplats.grow_capacity(jm, 96))
    assert tg.capacity == 96 and tsplats.grow_capacity(tm, 64) is tm
    # two segments: each keeps its rows and gains half the new ones
    _assert_same_model(tsplats.grow_capacity(tm, 128, segments=2),
                       jsplats.grow_capacity(jm, 128, segments=2))


def _stats_pair(seed=3, n=40, c=64):
    """Both packages' models with the same accumulated statistics."""
    pts, rgb = _pcd(n, seed)
    rng = np.random.default_rng(seed)
    jm = jsplats.create_from_pcd(pts, rgb, capacity=c)
    tm = tsplats.create_from_pcd(pts, rgb, capacity=c, device="cpu")
    for _ in range(3):
        g = (rng.normal(size=(c, 2)) * 4e-4).astype(np.float32)
        radii = rng.integers(0, 30, c).astype(np.int32) * (rng.uniform(size=c) < 0.7)
        jm = jdensify.add_stats(jm, jnp.asarray(g), jnp.asarray(radii))
        tm = tdensify.add_stats(tm, to_torch(g), to_torch(radii))
    return tm, jm


def test_add_stats_matches_jax():
    tm, jm = _stats_pair()
    _assert_same_model(tm, jm)
    assert float(tm.denom.max()) == 3.0 and float(tm.max_radii2d.max()) > 0.0

def test_convert_carries_training_state():
    tm, jm = _stats_pair(seed=7)
    rng = np.random.default_rng(7)
    aj = joptim.AdamState(
        count=jnp.int32(17),
        mu=jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32), jm.params),
        nu=jax.tree.map(lambda a: jnp.asarray(rng.uniform(size=a.shape), jnp.float32), jm.params))
    state = {
        "params": {k: np.asarray(v) for k, v in jm.params._asdict().items()},
        "live": np.asarray(jm.live),
        "stats": {k: np.asarray(getattr(jm, k)) for k in tsplats.STATS},
        "adam": {"count": int(aj.count),
                 "mu": {k: np.asarray(v) for k, v in aj.mu._asdict().items()},
                 "nu": {k: np.asarray(v) for k, v in aj.nu._asdict().items()}},
    }
    model, adam = convert.state_from_numpy(state, device="cpu")
    _assert_same_model(model, jm, tol=0.0)
    assert adam.count == 17
    back = convert.state_to_numpy(model, adam)

    def flat(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield prefix + k, v

    want, got = dict(flat(state)), dict(flat(back))
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # back into the JAX package: the arrays are its leaves
    jm_back = jsplats.SplatModel(params=jsplats.SplatParams(**back["params"]), live=back["live"],
                                 **back["stats"])
    assert int(jm_back.num_live()) == int(jm.num_live())
