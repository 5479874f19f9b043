"""tpu2dgs_torch's training losses against tpu2dgs's on the same numpy
images, and the gradient of the photometric loss (through SSIM):
allclose 1e-6 where the arithmetic is elementwise float32, 1e-5 for SSIM
(sums of 121 products in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_core import to_torch
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_train import _close
from tpu2dgs.train import losses as jlosses
from tpu2dgs_torch.train import losses as tlosses


# -- losses -----------------------------------------------------------------

def _images():
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(3, 37, 52)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    return a, b


LOSSES = {
    "l1": (lambda m, a, b: m.l1_loss(a, b), 1e-6),
    "l2": (lambda m, a, b: m.l2_loss(a, b), 1e-6),
    "ssim": (lambda m, a, b: m.ssim(a, b), 1e-5),
    "photometric": (lambda m, a, b: m.photometric_loss(a, b, 0.2)[0], 1e-5),
    "normal": (lambda m, a, b: m.normal_consistency_loss(a, b), 1e-6),
    "distortion": (lambda m, a, b: m.distortion_loss(a[:1]), 1e-6),
    "psnr": (lambda m, a, b: m.psnr(a, b), 1e-5),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name):
    fn, tol = LOSSES[name]
    a, b = _images()
    _close(fn(tlosses, to_torch(a), to_torch(b)), fn(jlosses, jnp.asarray(a), jnp.asarray(b)),
           tol, name)


def test_ssim_gradient_matches_jax():
    a, b = _images()
    gj = jax.grad(lambda x: jlosses.photometric_loss(x, jnp.asarray(b), 0.2)[0])(jnp.asarray(a))
    x = to_torch(a).requires_grad_()
    gt, = torch.autograd.grad(tlosses.photometric_loss(x, to_torch(b), 0.2)[0], x)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-8)
