"""tpu2dgs_torch's Adam step and moment surgery against tpu2dgs's, on the
same numpy parameters and gradients over many magnitudes, allclose 1e-6
(elementwise float32 arithmetic)."""

import jax.numpy as jnp
import numpy as np

from tests.test_torch_core import to_torch
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_train import FIELDS, _close, _np
from tpu2dgs.model import optim as joptim
from tpu2dgs.model import splats as jsplats
from tpu2dgs_torch.model import optim as toptim
from tpu2dgs_torch.model import splats as tsplats


def _random_params(rng, c=48):
    return {"xyz": rng.normal(size=(c, 3)), "features_dc": rng.normal(size=(c, 1, 3)),
            "features_rest": rng.normal(size=(c, 15, 3)),
            "scaling": rng.uniform(-3.0, -1.0, (c, 2)), "rotation": rng.normal(size=(c, 4)),
            "opacity": rng.normal(size=(c, 1))}


def _both_params(d):
    d = {k: np.asarray(v, np.float32) for k, v in d.items()}
    return (jsplats.SplatParams(**{k: jnp.asarray(v) for k, v in d.items()}),
            tsplats.SplatParams(**{k: to_torch(v) for k, v in d.items()}))


def test_adam_step_and_surgery_match_jax():
    rng = np.random.default_rng(1)
    pj, pt = _both_params(_random_params(rng))
    live = rng.uniform(size=48) < 0.8
    aj, at = joptim.init_adam(pj), toptim.init_adam(pt)
    cfg_j, cfg_t = joptim.OptimConfig(), toptim.OptimConfig()
    for step in (1.0, 2.0, 3.0):
        # gradients over many magnitudes, some exactly zero
        g = {k: v * 10.0 ** rng.uniform(-8, 0, v.shape) * (rng.uniform(size=v.shape) < 0.9)
             for k, v in _random_params(rng).items()}
        gj, gt = _both_params(g)
        pj, aj = joptim.adam_step(cfg_j, pj, gj, aj, joptim.learning_rates(
            cfg_j, jnp.float32(step), 1.5), jnp.asarray(live))
        pt, at = toptim.adam_step(cfg_t, pt, gt, at, toptim.learning_rates(cfg_t, step, 1.5),
                                  to_torch(live))
        if step == 2.0:
            rows = rng.uniform(size=48) < 0.3
            aj, at = joptim.surgery(aj, jnp.asarray(rows)), toptim.surgery(at, to_torch(rows))
            assert float(at.mu.xyz[to_torch(rows)].abs().max()) == 0.0
    assert at.count == int(aj.count) == 3
    for name in FIELDS:
        _close(getattr(pt, name), getattr(pj, name), 1e-6, f"param {name}")
        _close(getattr(at.mu, name), getattr(aj.mu, name), 1e-6, f"mu {name}")
        np.testing.assert_allclose(_np(getattr(at.nu, name)), _np(getattr(aj.nu, name)),
                                   rtol=1e-6, atol=1e-12, err_msg=f"nu {name}")
