"""tpu2dgs_torch's blend math and oracle rasterizer against tpu2dgs's, on
the same numpy inputs, outputs and gradients at rtol = atol = 1e-5:

  * blend.splat_pixel_response, blend_chunk, finalize and map_depth on the
    splats of a preprocessed scene (the JAX package's preprocess output fed
    to both sides), and the gradient of a loss through one blended chunk;
  * rasterize_oracle at 64x64 (tests/test_oracle.py's size) on the same
    preprocessed splats, and the gradient of a loss over all its maps with
    respect to the splats' transforms, opacities, colours and normals, the
    JAX side run op by op (jax.disable_jit);
  * the single-splat and two-splat occlusion cases of tests/test_oracle.py,
    against both JAX and the analytic values there.

Each file of these tests keeps to six items or fewer: the test runner
queues files by their number of items, and more would put these compiles
ahead of the suite's longest file.

PyTorch runs on one thread here (tests/test_torch_threads.py's
`one_torch_thread`, which says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_oracle import _single_splat
from tests.test_tiled import _cam, _random_scene, _settings, KEYS
from tests.test_torch_core import jax_preprocess, port_cam, to_torch
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.raster import blend as jblend
from tpu2dgs.raster import oracle as joracle
from tpu2dgs.raster import preprocess as jpre
from tpu2dgs.raster.api import render as jrender
from tpu2dgs_torch.raster import api as tapi
from tpu2dgs_torch.raster import blend as tblend
from tpu2dgs_torch.raster import oracle as toracle
from tpu2dgs_torch.raster.preprocess import SplatScreen

TOL = dict(rtol=1e-5, atol=1e-5)
W = H = 64
BG = np.array([0.1, 0.2, 0.3], np.float32)


def _port_render(cam, settings, args, bg, **kw):
    return tapi.render(cam, settings, *args, bg, device="cpu", **kw)


# -- the blend math -------------------------------------------------------------


@pytest.fixture(scope="module")
def chunk_inputs():
    """One chunk: the first 32 depth-ordered splats of a 200-splat scene
    (opacity raised to at least 0.9) against every pixel of a 40x24
    image."""
    w, h = 40, 24
    splats = jax_preprocess(*_random_scene(n=200, seed=3), _cam(w, h), w, h, 3)
    order = np.argsort(np.asarray(splats.depth), kind="stable")[:32]
    pick = {f: np.asarray(getattr(splats, f))[order]
            for f in ("tmat", "filter_center", "opacity", "color", "normal")}
    pick["opacity"] = np.maximum(pick["opacity"], np.float32(0.9))
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    return pick, xs.reshape(-1), ys.reshape(-1)


def _t(a):
    return a if isinstance(a, torch.Tensor) else to_torch(a)


def _run_chunk(mod, conv, pick, px, py, passes=1):
    """The chunk composited `passes` times over an empty state."""
    alpha, depth, contrib = mod.splat_pixel_response(
        conv(pick["tmat"]), conv(pick["filter_center"]), conv(pick["opacity"]),
        conv(px), conv(py))
    if mod is jblend:
        state = jblend.init_state(px.shape[0])
    else:
        state = tblend.init_state(px.shape[0])
    for _ in range(passes):
        state = mod.blend_chunk(state, alpha, depth, contrib, conv(pick["color"]),
                                conv(pick["normal"]))
    color, maps = mod.finalize(state, conv(BG))
    return alpha, depth, contrib, state, color, maps


def test_blend_chunk_matches_jax(chunk_inputs):
    pick, px, py = chunk_inputs
    j = _run_chunk(jblend, jnp.asarray, pick, px, py, passes=4)
    t = _run_chunk(tblend, _t, pick, px, py, passes=4)
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))  # contrib
    assert 0 < int(np.asarray(j[2]).sum()) < j[2].size
    for a, b, name in ((j[0], t[0], "alpha"), (j[1], t[1], "depth"), (j[4], t[4], "color")):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name, **TOL)
    for name in jblend.PixelState._fields:
        a, b = np.asarray(getattr(j[3], name)), getattr(t[3], name).numpy()
        if name == "done":
            np.testing.assert_array_equal(b, a)
            assert a.any()  # the later passes saturate some pixels
        else:
            np.testing.assert_allclose(b, a, err_msg=name, **TOL)
    for k in j[5]:
        np.testing.assert_allclose(t[5][k].numpy(), np.asarray(j[5][k]), err_msg=k, **TOL)
    depth = np.linspace(-1.0, 50.0, 101, dtype=np.float32)
    np.testing.assert_allclose(tblend.map_depth(to_torch(depth)).numpy(),
                               np.asarray(jblend.map_depth(jnp.asarray(depth))), **TOL)


def test_blend_chunk_gradients_match_jax(chunk_inputs):
    """Gradient of one composited chunk with respect to tmat, colour,
    opacity and normal (the filter centres carry none, by design)."""
    pick, px, py = chunk_inputs
    names = ("tmat", "color", "opacity", "normal")

    def loss(mod, xp, conv, *vals):
        p = dict(pick, **dict(zip(names, vals)))
        *_, color, maps = _run_chunk(mod, conv, p, px, py)
        return (xp.sum(color ** 2) + xp.sum(maps["distortion"])
                + 0.1 * xp.sum(maps["depth_expected"]) + 0.1 * xp.sum(maps["normal"])
                + 0.1 * xp.sum(maps["depth_median"]))

    gj = jax.grad(lambda *v: loss(jblend, jnp, jnp.asarray, *v), argnums=(0, 1, 2, 3))(
        *(jnp.asarray(pick[n]) for n in names))
    targs = [to_torch(pick[n]).requires_grad_() for n in names]
    gt = torch.autograd.grad(loss(tblend, torch, _t, *targs), targs)
    for a, b, name in zip(gj, gt, names):
        assert float(np.abs(np.asarray(a)).max()) > 0.0, name
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name, **TOL)


# -- the oracle ------------------------------------------------------------------

SPLAT_GRADS = ("tmat", "opacity", "color", "normal")


def _maps_loss(image, allmap, xp):
    return (xp.sum(image ** 2) + xp.sum(allmap["distortion"])
            + 0.1 * xp.sum(allmap["depth_expected"]) + 0.1 * xp.sum(allmap["normal"])
            + 0.1 * xp.sum(allmap["depth_median"]) + xp.sum(allmap["alpha"]))


def _rasterized():
    """rasterize_oracle of both packages on the JAX package's preprocessed
    64x64 scene: outputs, and gradients with respect to SPLAT_GRADS."""
    splats = jpre.preprocess(*_random_scene(n=96, seed=4), _cam(W, H), W, H, 3)

    def jloss(*vals):
        sp = splats._replace(**dict(zip(SPLAT_GRADS, vals)))
        image, allmap = joracle.rasterize_oracle(sp, W, H, jnp.asarray(BG), chunk=32)
        return _maps_loss(image, allmap, jnp), (image, allmap)

    # Op by op: XLA's compiled scan contracts multiplies and adds, which
    # alone moves tmat gradients up to 7x the tolerance away from the same
    # function run op by op (the port lies within it of the latter).
    with jax.disable_jit():
        (_, jout), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
            *(getattr(splats, f) for f in SPLAT_GRADS))
    tsp = SplatScreen(*(to_torch(np.asarray(a)) for a in splats))
    leaves = {f: getattr(tsp, f).requires_grad_() for f in SPLAT_GRADS}
    image, allmap = toracle.rasterize_oracle(tsp._replace(**leaves), W, H, to_torch(BG),
                                             chunk=32)
    gt = torch.autograd.grad(_maps_loss(image, allmap, torch), list(leaves.values()))
    return jout, (image, allmap), dict(zip(SPLAT_GRADS, zip(gj, gt)))


def test_rasterize_oracle_matches_jax():
    (jimage, jmaps), (timage, tmaps), grads = _rasterized()
    np.testing.assert_allclose(timage.detach().numpy(), np.asarray(jimage), **TOL)
    assert set(tmaps) == set(jmaps)
    for k in jmaps:
        np.testing.assert_allclose(tmaps[k].detach().numpy(), np.asarray(jmaps[k]),
                                   err_msg=k, **TOL)
    assert float(np.asarray(jmaps["alpha"]).mean()) > 0.05
    for name, (gj, gt) in grads.items():
        gj = np.asarray(gj)
        assert float(np.abs(gj).max()) > 0.0, name
        np.testing.assert_allclose(gt.numpy(), gj, err_msg=name, **TOL)


def _both(w, h, scene, bg=np.zeros(3, np.float32)):
    jout = jax.jit(lambda *a: jrender(_cam(w, h), _settings(w, h, "oracle", sh_degree=0), *a))(
        *(jnp.asarray(np.asarray(a)) for a in scene), jnp.asarray(bg))
    tout = _port_render(port_cam(w, h), tapi.RasterSettings(w, h, sh_degree=0, backend="oracle"),
                        [to_torch(np.asarray(a)) for a in scene], to_torch(bg))
    for k in KEYS + ["depth_expected", "mean2d"]:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), err_msg=k, **TOL)
    np.testing.assert_array_equal(tout["radii"].numpy(), np.asarray(jout["radii"]))
    return {k: v.numpy() for k, v in tout.items()}


def test_single_splat_matches_jax_and_analytic():
    """tests/test_oracle.py::test_facing_disk_alpha_profile on the port."""
    s = 0.125  # world sigma; focal 32, z = 2 -> 2 px on screen
    out = _both(W, H, _single_splat((0.0, 0.0, 2.0), (s, s)))
    img, alpha = out["render"], out["rend_alpha"][0]
    cx = (W - 1) / 2.0
    for px, py in [(31, 31), (33, 31), (35, 35)]:
        d2 = ((px - cx) / 2.0) ** 2 + ((py - cx) / 2.0) ** 2
        rho2d = 2.0 * ((px - cx) ** 2 + (py - cx) ** 2)
        expected = 0.9 * np.exp(-0.5 * min(d2, rho2d))
        expected = 0.0 if expected < 1 / 255.0 else expected
        np.testing.assert_allclose(alpha[py, px], expected, atol=2e-3)
        np.testing.assert_allclose(img[0, py, px], expected, atol=2e-3)
        assert img[1, py, px] < 1e-6
    np.testing.assert_allclose(out["depth_expected"][0, 31, 31], 2.0, atol=1e-4)
    np.testing.assert_allclose(out["depth_median"][0, 31, 31], 2.0, atol=1e-4)
    np.testing.assert_allclose(out["rend_normal"][2, 31, 31], -alpha[31, 31], atol=2e-3)
    assert out["visibility_filter"][0] and int(out["radii"][0]) >= 6


def test_occlusion_order_matches_jax():
    """tests/test_oracle.py::test_two_splats_occlusion_order on the port:
    the near red splat in front of the far green one, listed far first."""
    w = h = 32
    from tpu2dgs.core import sh

    rgbs = jnp.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]], jnp.float32)
    scene = (np.array([[0.0, 0.0, 4.0], [0.0, 0.0, 2.0]], np.float32),
             np.array([[0.5, 0.5], [0.25, 0.25]], np.float32),
             np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (2, 1)),
             np.array([0.9, 0.9], np.float32),
             np.asarray(jnp.zeros((2, 16, 3)).at[:, 0, :].set(sh.rgb_to_sh(rgbs))))
    out = _both(w, h, scene)
    c = (w - 1) // 2
    assert out["render"][0, c, c] > 0.8 and out["render"][1, c, c] < 0.15
    np.testing.assert_allclose(out["depth_median"][0, c, c], 2.0, atol=1e-3)
    assert out["rend_dist"][0, c, c] > 1e-6
