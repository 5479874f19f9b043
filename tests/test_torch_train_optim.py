"""tpu2dgs_torch's learning-rate schedules against tpu2dgs's, on the same
numpy inputs, allclose 1e-6 (elementwise float32 arithmetic). The Adam
step and moment surgery are tests/test_torch_train_optim_adam.py's."""

import jax.numpy as jnp
import pytest

from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_train import FIELDS, _close
from tpu2dgs.model import optim as joptim
from tpu2dgs_torch.model import optim as toptim


# -- optimizer --------------------------------------------------------------

@pytest.mark.parametrize("step", [0.0, 1.0, 150.0, 7000.0, 30000.0, 50000.0])
def test_learning_rates_match_jax(step):
    cfg = dict(position_lr_init=2e-4, position_lr_delay_mult=0.02, feature_lr=3e-3)
    lj = joptim.learning_rates(joptim.OptimConfig(**cfg), jnp.float32(step), 2.5)
    lt = toptim.learning_rates(toptim.OptimConfig(**cfg), step, 2.5)
    for name in FIELDS:
        _close(getattr(lt, name), getattr(lj, name), 1e-6, name)
    _close(toptim.expon_lr(step, 1e-2, 1e-4, lr_delay_steps=100, lr_delay_mult=0.1,
                           max_steps=30000),
           joptim.expon_lr(jnp.float32(step), 1e-2, 1e-4, lr_delay_steps=100,
                           lr_delay_mult=0.1, max_steps=30000), 1e-6)
