"""tpu2dgs_torch's render options on the CPU (the kernels' plain
versions), on tests/test_torch_render.py's basic scene: the reference
PipelineParams paths render what the default path renders, the median
depth at depth_ratio 1, and the paths that are ignored or refused."""

import numpy as np
import pytest
import torch

from tests.test_tiled import KEYS
from tests.test_torch_core import port_cam, to_torch
from tests.test_torch_render import _basic
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs_torch.core import sh as tsh
from tpu2dgs_torch.core import transforms as ttf
from tpu2dgs_torch.raster import api as tapi


def _port_options(case):
    """Render keyword arguments that must reproduce the default render."""
    w, h, arrays, _, _ = _basic()
    xyz, scaling, rotation, opacity, features = map(to_torch, arrays)
    if case == "axes_override":
        return dict(axes_override=ttf.splat_axes(scaling, rotation))
    if case == "override_color":
        dirs = ttf.normalize(xyz)  # the test camera sits at the origin
        rgb = torch.clamp(tsh.eval_sh(3, features.swapaxes(-1, -2), dirs) + 0.5, min=0.0)
        return dict(override_color=rgb)
    return {case: True}


@pytest.mark.parametrize("case", ["axes_override", "compute_cov3d_python",
                                  "convert_shs_python", "override_color"])
def test_render_options_match_default(case):
    """The reference PipelineParams paths (SH and tangent axes evaluated
    outside preprocess) render what the default path renders."""
    w, h, arrays, bg, caps = _basic()
    args = (port_cam(w, h), tapi.RasterSettings(w, h, **caps), *map(to_torch, arrays),
            to_torch(bg))
    ref = tapi.render(*args, device="cpu")
    got = tapi.render(*args, device="cpu", **_port_options(case))
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_median_depth_ratio_and_unported_paths():
    w, h, arrays, bg, caps = _basic()
    args = (port_cam(w, h), tapi.RasterSettings(w, h, depth_ratio=1.0, **caps),
            *map(to_torch, arrays), to_torch(bg))
    out = tapi.render(*args, device="cpu")
    assert torch.equal(out["surf_depth"], out["depth_median"])
    # without a mesh, shard_splats is ignored, as in the JAX package (the
    # sharded render is held in tests/test_torch_splat_sharded.py)
    alone = tapi.render(*args, device="cpu", shard_splats=True)
    for k in KEYS:
        assert torch.equal(alone[k], out[k]), k
    # mesh= renders tile rows (tests/test_torch_sharded.py); it must be a
    # parallel.distributed.Mesh
    with pytest.raises(TypeError):
        tapi.render(*args, device="cpu", mesh=object())
    # the tiled backend is ported: it renders (held against JAX in
    # tests/test_torch_tiled.py)
    tiled = tapi.render(args[0], tapi.RasterSettings(w, h, backend="tiled", depth_ratio=1.0),
                        *args[2:], device="cpu")
    assert torch.equal(tiled["surf_depth"], tiled["depth_median"])
    with pytest.raises(ValueError):
        tapi.RasterSettings(w, h, backend="pallas")
