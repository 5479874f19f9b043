"""Gradients through tpu2dgs_torch's training loss on the CPU (plain
versions of the kernels): no NaN from an all-dead model or from culled
splats with all three training loss terms on, and nothing kept for a
backward pass under no_grad. The gradients against jax.grad are
tests/test_torch_grad.py's."""

import numpy as np
import pytest
import torch

from tests.test_tiled import _random_scene
from tests.test_torch_core import port_cam, to_torch
from tests.test_torch_grad import BG, CAPS, H, W
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs_torch.model import splats as tsplats
from tpu2dgs_torch.raster import api as tapi
from tpu2dgs_torch.train import loop as tloop


def _training_grads(model, w=64, h=32):
    cam = port_cam(w, h)
    gt = torch.full((3, h, w), 0.3)
    settings = tapi.RasterSettings(w, h, bin_capacity=128, tile_capacity=128)
    loss, _, gparams, goffset = tloop.view_gradients(
        model, settings, cam, gt, torch.zeros(3), 0.2, 0.05, 100.0)
    return loss, [*gparams, goffset]


@pytest.mark.parametrize("case", ["all_dead", "culled"])
def test_training_gradients_are_finite(case):
    """All three loss terms on (photometric, normal, distortion)."""
    if case == "all_dead":
        model = tsplats.empty_model(128, device="cpu")
    else:
        rng = np.random.default_rng(3)
        pts = rng.uniform(-0.6, 0.6, (40, 3)).astype(np.float32) + [0, 0, 2.5]
        pts[:10, 2] = -1.0     # behind the camera
        pts[10:20, 0] = 50.0   # off screen
        pts[20] = 0.0          # at the camera center
        model = tsplats.create_from_pcd(pts, rng.uniform(size=(40, 3)), capacity=64,
                                        device="cpu")
        model.opacity.data[21:30] = 3.0
    loss, grads = _training_grads(model)
    assert bool(torch.isfinite(loss))
    for g in grads:
        assert bool(torch.isfinite(g).all())
    if case == "all_dead":
        assert all(float(g.abs().max()) == 0.0 for g in grads)
    else:
        assert float(grads[0][21:40].abs().max()) > 0.0
        assert float(grads[0][:20].abs().max()) == 0.0


def test_render_under_no_grad_saves_nothing():
    scene = [to_torch(a).requires_grad_() for a in _random_scene(n=48, seed=22)]
    args = (port_cam(W, H), tapi.RasterSettings(W, H, **CAPS), *scene, to_torch(BG))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        with torch.no_grad():
            out = tapi.render(*args, device="cpu")
        assert not saved
        assert all(v.grad_fn is None and not v.requires_grad for v in out.values())
        out = tapi.render(*args, device="cpu")
        assert saved and out["render"].requires_grad
