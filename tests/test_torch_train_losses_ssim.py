"""tpu2dgs_torch's losses through SSIM against tpu2dgs's on
tests/test_torch_train_losses.py's images (1e-5: sums of 121 products in
another order), and the gradient of the photometric loss through SSIM
(rtol 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_core import to_torch
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_train_losses import THROUGH_SSIM, _images, loss_matches_jax
from tpu2dgs.train import losses as jlosses
from tpu2dgs_torch.train import losses as tlosses


@pytest.mark.parametrize("name", THROUGH_SSIM)
def test_loss_matches_jax(name):
    loss_matches_jax(name)


def test_ssim_gradient_matches_jax():
    a, b = _images()
    gj = jax.grad(lambda x: jlosses.photometric_loss(x, jnp.asarray(b), 0.2)[0])(jnp.asarray(a))
    x = to_torch(a).requires_grad_()
    gt, = torch.autograd.grad(tlosses.photometric_loss(x, to_torch(b), 0.2)[0], x)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-8)
