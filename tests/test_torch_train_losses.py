"""tpu2dgs_torch's training losses against tpu2dgs's on the same numpy
images: allclose 1e-6 where the arithmetic is elementwise float32, 1e-5
for PSNR. The losses through SSIM and the photometric loss's gradient are
tests/test_torch_train_losses_ssim.py's."""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_core import to_torch
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_train import _close
from tpu2dgs.train import losses as jlosses
from tpu2dgs_torch.train import losses as tlosses


# -- losses -----------------------------------------------------------------

def _images():
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(3, 37, 52)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    return a, b


# name: (the loss of a module, tolerance); those through SSIM are in
# tests/test_torch_train_losses_ssim.py, where the same test takes them
LOSSES = {
    "l1": (lambda m, a, b: m.l1_loss(a, b), 1e-6),
    "l2": (lambda m, a, b: m.l2_loss(a, b), 1e-6),
    "ssim": (lambda m, a, b: m.ssim(a, b), 1e-5),
    "photometric": (lambda m, a, b: m.photometric_loss(a, b, 0.2)[0], 1e-5),
    "normal": (lambda m, a, b: m.normal_consistency_loss(a, b), 1e-6),
    "distortion": (lambda m, a, b: m.distortion_loss(a[:1]), 1e-6),
    "psnr": (lambda m, a, b: m.psnr(a, b), 1e-5),
}
THROUGH_SSIM = ["photometric", "ssim"]


def loss_matches_jax(name):
    fn, tol = LOSSES[name]
    a, b = _images()
    _close(fn(tlosses, to_torch(a), to_torch(b)), fn(jlosses, jnp.asarray(a), jnp.asarray(b)),
           tol, name)


@pytest.mark.parametrize("name", sorted(set(LOSSES) - set(THROUGH_SSIM)))
def test_loss_matches_jax(name):
    loss_matches_jax(name)
