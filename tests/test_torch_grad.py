"""Gradients through tpu2dgs_torch's render (plain versions of the
kernels, on the CPU) vs jax.grad through the JAX Pallas backend in
interpret mode: a loss with render, distortion, normal and median terms,
with respect to xyz, scaling, rotation, opacity, features and
mean2d_offset, at the repo's own gradient tolerance (rtol 3e-3, atol 3e-5,
tests/test_pallas.py). The training loss's finite gradients and render
under no_grad are tests/test_torch_grad_finite.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_tiled import _cam, _random_scene, _settings
from tests.test_torch_core import port_cam, to_torch
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.raster.api import render as jrender
from tpu2dgs_torch.raster import api as tapi

W, H = 128, 32
CAPS = dict(bin_capacity=64, tile_capacity=64)
BG = np.array([0.05, 0.05, 0.05], np.float32)
NAMES = ["xyz", "scaling", "rotation", "opacity", "features", "mean2d_offset"]


def _loss_terms(out, xp):
    # the loss of tests/test_pallas.py::test_pallas_gradients_match_oracle
    return (xp.sum(out["render"] ** 2) + xp.sum(out["rend_dist"])
            + 0.1 * xp.sum(out["rend_normal"] * out["surf_normal"])
            + 0.05 * xp.sum(out["depth_median"]))


@pytest.fixture(scope="module")
def grads():
    scene = _random_scene(n=48, seed=22)
    offset = np.zeros((48, 2), np.float32)

    def loss_j(*args):
        out = jrender(_cam(W, H), _settings(W, H, "pallas", debug=True, **CAPS), *args[:5],
                      jnp.asarray(BG), mean2d_offset=args[5])
        return _loss_terms(out, jnp)

    gj = jax.jit(jax.grad(loss_j, argnums=tuple(range(6))))(*scene, jnp.asarray(offset))

    targs = [to_torch(a).requires_grad_() for a in (*scene, offset)]
    out = tapi.render(port_cam(W, H), tapi.RasterSettings(W, H, **CAPS), *targs[:5],
                      to_torch(BG), mean2d_offset=targs[5], device="cpu")
    gt = torch.autograd.grad(_loss_terms(out, torch), targs)
    return dict(zip(NAMES, zip(gj, gt)))


@pytest.mark.parametrize("name", NAMES)
def test_render_gradient_matches_jax(grads, name):
    gj, gt = grads[name]
    gj = np.asarray(gj)
    assert float(np.abs(gj).max()) > 0.0
    np.testing.assert_allclose(gt.numpy(), gj, rtol=3e-3, atol=3e-5, err_msg=name)
