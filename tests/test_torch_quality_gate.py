"""tpu2dgs_torch.eval.quality_gate against scripts/quality_gate.py.

  * the generating shell and its surface samples equal the script's
    (imported from it: numpy only at module level);
  * the thresholds and the verdict are the script's, read from its source;
  * one ground-truth view at 32x32 through the port's tiled backend
    against the JAX package's tiled render of the same shell and camera;
  * the whole pipeline on the CPU at 32x32 and 20 iterations, in the soak
    schedule (1500 initial points) with the tiled backend training: the
    report has the script's keys, its verdict is computed from the
    script's thresholds, and the trained model renders alike through the
    cuda backend's plain versions and the tiled backend.

PyTorch runs on one thread: the file runs beside the suite's longest one,
and fewer threads take less from it.
"""

import ast
import importlib.util
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.core import cameras as jcam
from tpu2dgs.raster.api import RasterSettings as JaxSettings
from tpu2dgs.raster.api import render as jrender
from tpu2dgs_torch.eval import quality_gate as tq

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "scripts", "quality_gate.py")


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("jax_quality_gate", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _script_thresholds():
    """The script's thresholds: the report's dict literal, and the soak
    run's assignments into report["thresholds"]."""
    with open(SCRIPT) as f:
        tree = ast.parse(f.read())
    standard, soak = None, {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "thresholds":
                    standard = ast.literal_eval(v)
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript):
            target = node.targets[0]
            if ast.unparse(target.value) == "report['thresholds']":
                soak[ast.literal_eval(target.slice)] = ast.literal_eval(node.value)
    return standard, {**standard, **soak}


def test_shell_equals_the_scripts(script):
    for a, b in zip(script.make_shell(), tq.make_shell()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(tq.shell_surface_points(), script.shell_surface_points())


def test_thresholds_and_verdict_are_the_scripts():
    standard, soak = _script_thresholds()
    assert standard == {"psnr_db": 19.0, "chamfer": 0.06, "backend_cross_psnr_db": 40.0}
    assert soak == dict(standard, chamfer=0.12, final_points=6000)
    for psnr, chamfer, cross, points, is_soak in itertools.product(
            (18.99, 19.0, 25.0), (0.06, 0.0601, 0.12, 0.1201), (39.9, 40.0, 120.0),
            (5999, 6000), (False, True)):
        t = soak if is_soak else standard
        want = (psnr >= t["psnr_db"] and chamfer <= t["chamfer"]
                and cross >= t["backend_cross_psnr_db"]
                and points >= t.get("final_points", 0))
        thresholds, ok = tq.verdict(psnr, chamfer, cross, points, is_soak)
        assert thresholds == t and ok == want, (psnr, chamfer, cross, points, is_soak)


def test_ground_truth_view_matches_jax():
    """View 1 of the orbit (the cross-check's view) at 32x32."""
    cam, _ = tq.orbit_views(32)[1]
    got = tq.render_ground_truth(cam, 32, "cpu").numpy()
    xyz, rgb, scaling, rotation, opacity = tq.make_shell()
    jc = jcam.Camera(uid=cam.uid, image_name=cam.image_name, R=cam.R, T=cam.T,
                     fovx=cam.fovx, fovy=cam.fovy, width=32, height=32)
    st = JaxSettings(width=32, height=32, sh_degree=0, backend="tiled", **tq.GT_CAPS)
    want = jax.jit(lambda *a: jrender(jc.arrays(), st, *a, jnp.zeros(3))["render"])(
        *(jnp.asarray(a) for a in (xyz, scaling, rotation, opacity, tq.shell_features(rgb))))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    assert float(got.max()) > 0.3  # the shell fills the view


def test_pipeline_on_the_cpu(tmp_path):
    report = tq.main(str(tmp_path), iters=20, res=32, soak=True, backend="tiled",
                     device="cpu")
    assert {"metric", "backend", "psnr_db", "ssim", "chamfer", "mesh_vertices",
            "backend_cross_psnr_db", "final_points", "thresholds", "pass",
            "soak"} <= set(report)
    assert report["backend"] == "tiled" and report["device"] == "cpu"
    assert report["thresholds"] == _script_thresholds()[1]
    assert report["pass"] == tq.verdict(report["psnr_db"], report["chamfer"],
                                        report["backend_cross_psnr_db"],
                                        report["final_points"], True)[1]
    assert report["final_points"] == 1500 and report["mesh_vertices"] > 0
    assert all(np.isfinite(report[k]) for k in ("psnr_db", "ssim", "chamfer"))
    # Both backends at untruncated capacities: the plain versions of the
    # kernels and the tiled backend render the trained model alike.
    assert report["backend_cross_psnr_db"] >= 40.0
    model = os.path.join(tmp_path, "model")
    assert os.path.exists(os.path.join(model, "train", "ours_20", "fuse_post.ply"))
    assert sorted(os.listdir(os.path.join(model, "test", "ours_20", "renders"))) == \
        [f"{i:05d}.png" for i in range(12)]
