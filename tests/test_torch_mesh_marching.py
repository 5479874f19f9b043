"""tpu2dgs_torch.mesh's marching tetrahedra (equal outputs), contraction
(allclose at 1e-6) and the colours of a culled mesh, against tpu2dgs.mesh,
on the inputs of tests/test_mesh.py. Fusion is tests/test_torch_mesh.py's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_mesh import _sphere_grid
from tests.test_torch_mesh import H, W
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.core import cameras as jcam
from tpu2dgs.mesh import cull as jcull
from tpu2dgs.mesh import marching as jmarching
from tpu2dgs.mesh import tsdf as jtsdf
from tpu2dgs_torch.core import cameras as tcam
from tpu2dgs_torch.mesh import cull as tcull
from tpu2dgs_torch.mesh import extract as textract
from tpu2dgs_torch.mesh import marching as tmarching
from tpu2dgs_torch.mesh import tsdf as ttsdf


def _marching_case(name):
    field, ax = _sphere_grid()
    spacing = (ax[1] - ax[0],) * 3
    if name == "sphere":
        return field, dict(origin=(-1, -1, -1), spacing=spacing)
    if name == "masked":
        mask = np.random.default_rng(1).random(field.shape) > 0.2
        return field, dict(origin=(-1, -1, -1), spacing=spacing, mask=mask)
    if name == "fully_masked":
        return field, dict(mask=np.zeros_like(field, bool))
    return np.ones((8, 8, 8)), {}  # no crossing


@pytest.mark.parametrize("case", ["sphere", "masked", "fully_masked", "no_crossing"])
def test_marching_matches_jax(case):
    field, kw = _marching_case(case)
    tv, tf = tmarching.marching_tetrahedra(field, 0.0, **kw)
    jv, jf = jmarching.marching_tetrahedra(field, 0.0, **kw)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert (tf.shape[0] > 500) == (case in ("sphere", "masked"))


def test_contract_uncontract_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(scale=2.0, size=(1000, 3)).astype(np.float32)
    x[:10] *= 1e-13  # the 1e-12 floor of the norm
    y = ttsdf.contract(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jtsdf.contract(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    back = ttsdf.uncontract(y)
    np.testing.assert_allclose(back.numpy(),
                               np.asarray(jtsdf.uncontract(jnp.asarray(y.numpy()))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-4, atol=1e-4)

def test_cull_colours_follow_vertices():
    """A vertex seen by the view but left in no kept face (its one face
    holds a hidden vertex) is dropped with its colour: colours indexed by
    the returned mask stay with their vertices through post-processing."""
    cam = dict(uid=0, image_name="c", R=np.eye(3), T=np.zeros(3),
               fovx=np.pi / 2, fovy=np.pi / 2, width=W, height=H)
    depth = np.full((1, H, W), 2.0, np.float32)
    pts = np.array([[0.0, 0.0, 1.0], [0.1, 0.0, 1.0], [0.0, 0.1, 1.0],
                    [0.0, 0.0, 3.0], [0.1, 0.1, 1.0]], np.float32)
    tri = np.array([[0, 1, 2], [4, 3, 0]])  # vertex 4 is seen, its face is not
    colors = np.arange(15, dtype=np.float64).reshape(5, 3) / 15.0
    v2, f2, kept = tcull.cull_mesh(pts, tri, [tcam.Camera(**cam)], [depth], eps=0.05)
    seen = jcull.cull_mesh(pts, tri, [jcam.Camera(**cam)], [depth], eps=0.05)[2]
    np.testing.assert_array_equal(seen, [True, True, True, False, True])
    np.testing.assert_array_equal(kept, [True, True, True, False, False])
    c2 = colors[kept]
    v3, f3, c3 = textract.post_process_mesh(v2, f2, c2, min_faces=1)
    np.testing.assert_array_equal(v3, pts[:3])
    np.testing.assert_array_equal(c3, colors[:3])
