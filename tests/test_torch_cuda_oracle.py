"""The port's cuda backend (the kernels' plain versions, on the CPU)
against the port's oracle, at tests/test_pallas.py's shapes and
tolerances: outputs at 150x90 with 120 splats (2e-4); gradients at 128x32
with 48 splats, each of the two held against the port's oracle run in
float64 at rtol 3e-3 / atol 3e-5, and the two against each other at twice
that: both carry float32 rounding of their own (on the worst rotation
element, 0.84 and 0.31 of the tolerance from the float64 value, in
opposite directions), so only their sum bounds their distance. Also: the
oracle under no_grad runs without checkpointing and gives the same bits.

PyTorch runs on one thread, and the file keeps to six items
(tests/test_torch_oracle.py says why of both).
"""

import numpy as np
import torch

from tests.test_tiled import KEYS, _random_scene
from tests.test_torch_core import port_cam, to_torch
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs_torch.core.cameras import CameraArrays
from tpu2dgs_torch.raster import api as tapi

NAMES = ["xyz", "scaling", "rotation", "opacity", "features", "mean2d_offset"]


def test_cuda_backend_matches_port_oracle():
    w, h = 150, 90  # not multiples of (128, 16): edge tiles are cropped
    scene = [to_torch(a) for a in _random_scene(n=120, seed=21)]
    bg = to_torch(np.array([0.15, 0.05, 0.3], np.float32))
    cam = port_cam(w, h)
    with torch.no_grad():
        out_o = tapi.render(cam, tapi.RasterSettings(w, h, backend="oracle"), *scene, bg,
                            device="cpu")
        out_c = tapi.render(cam, tapi.RasterSettings(w, h, bin_capacity=256, tile_capacity=128),
                            *scene, bg, device="cpu")
    for k in KEYS:
        np.testing.assert_allclose(out_c[k].numpy(), out_o[k].numpy(), rtol=2e-4, atol=2e-4,
                                   err_msg=k)
    np.testing.assert_array_equal(out_c["radii"].numpy(), out_o["radii"].numpy())
    assert float(out_c["tile_overflow_frac"]) == 0.0


def _pallas_loss(out, xp):
    # tests/test_pallas.py::test_pallas_gradients_match_oracle
    return (xp.sum(out["render"] ** 2) + xp.sum(out["rend_dist"])
            + 0.1 * xp.sum(out["rend_normal"] * out["surf_normal"])
            + 0.05 * xp.sum(out["depth_median"]))


def _cuda_oracle_grads():
    """Gradients at 128x32 through the port's oracle and cuda backend in
    float32, and through the port's oracle in float64."""
    w, h = 128, 32
    scene = _random_scene(n=48, seed=22)
    offset = np.zeros((48, 2), np.float32)
    bg = np.full(3, 0.05, np.float32)

    def grads(settings, dtype=torch.float32):
        cam = CameraArrays(*(a.to(dtype) for a in port_cam(w, h)))
        targs = [to_torch(a).to(dtype).requires_grad_() for a in (*scene, offset)]
        out = tapi.render(cam, settings, *targs[:5], to_torch(bg).to(dtype),
                          mean2d_offset=targs[5], device="cpu")
        return [g.double().numpy()
                for g in torch.autograd.grad(_pallas_loss(out, torch), targs)]

    oracle = tapi.RasterSettings(w, h, backend="oracle")
    g_o = grads(oracle)
    g_c = grads(tapi.RasterSettings(w, h, bin_capacity=64, tile_capacity=64))
    g_64 = grads(oracle, torch.float64)
    return dict(zip(NAMES, zip(g_o, g_c, g_64)))


def test_cuda_backend_gradients_match_port_oracle():
    for name, (go, gc, g64) in _cuda_oracle_grads().items():
        assert float(np.abs(g64).max()) > 0.0, name
        for g, label in ((gc, "cuda"), (go, "oracle")):
            np.testing.assert_allclose(g, g64, rtol=3e-3, atol=3e-5, err_msg=f"{name} {label}")
        np.testing.assert_allclose(gc, go, rtol=6e-3, atol=6e-5, err_msg=name)


def test_oracle_runs_without_grad_and_matches_with():
    """Under no_grad the chunks run without torch.utils.checkpoint: the same
    outputs, nothing kept for a backward pass."""
    scene = [to_torch(a) for a in _random_scene(n=40, seed=6)]
    settings = tapi.RasterSettings(32, 24, backend="oracle")
    cam, bg = port_cam(32, 24), to_torch(np.array([0.1, 0.2, 0.3], np.float32))
    with torch.no_grad():
        a = tapi.render(cam, settings, *scene, bg, device="cpu")
    b = tapi.render(cam, settings, *[x.requires_grad_() for x in scene], bg, device="cpu")
    assert a["render"].grad_fn is None and b["render"].grad_fn is not None
    for k in KEYS:
        np.testing.assert_array_equal(a[k].numpy(), b[k].detach().numpy())
