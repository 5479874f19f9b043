"""tpu2dgs_torch core modules vs tpu2dgs: cameras, SH, transforms,
preprocess, on the same numpy inputs, allclose 1e-6 (float32 arithmetic in
another order: matmuls and norms sum differently; one case states a wider
tolerance beside its reason). Also the port's
isolation from JAX and its refusal to fall back to the CPU."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_tiled import _cam, _random_scene
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.core import cameras as jcam
from tpu2dgs.core import sh as jsh
from tpu2dgs.core import transforms as jtf
from tpu2dgs.raster import api as japi
from tpu2dgs.raster import binning as jbin
from tpu2dgs.raster import pallas_backend as jpb
from tpu2dgs.raster import preprocess as jpre
import tpu2dgs_torch
from tpu2dgs_torch.core import cameras as tcam
from tpu2dgs_torch.core import sh as tsh
from tpu2dgs_torch.core import transforms as ttf
from tpu2dgs_torch.raster import api as tapi
from tpu2dgs_torch.raster import preprocess as tpre


# tpu2dgs's preprocess, compaction and record packing, each compiled as one
# program (width, height, SH degree and the compaction's length static): op
# by op each compiles every one of its operations alone. The port is held
# to the same functions of the same inputs.
jax_preprocess = jax.jit(jpre.preprocess, static_argnums=(6, 7, 8))
jax_compact = jax.jit(jbin.compact_visible, static_argnums=1)
jax_pack = jax.jit(jpb.pack_records)


def to_torch(a):
    """numpy/JAX array -> CPU tensor (a writable copy)."""
    return torch.from_numpy(np.array(a))


def port_cam(w, h, fov=np.pi / 2):
    """The port's counterpart of tests.test_tiled._cam, on the CPU."""
    return tcam.Camera(uid=0, image_name="t", R=np.eye(3), T=np.zeros(3),
                       fovx=fov, fovy=fov, width=w, height=h).arrays("cpu")


def _orbit(w, h):
    """A camera with rotation and translation (both sides from one pose)."""
    a = 0.7
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    T = np.array([0.3, -0.2, 2.5])
    kw = dict(uid=0, image_name="o", R=R, T=T, fovx=1.1, fovy=0.8, width=w, height=h)
    return jcam.Camera(**kw), tcam.Camera(**kw)


def _case_cameras():
    w, h = 40, 24
    jc, tc = _orbit(w, h)
    ja, ta = jc.arrays(), tc.arrays("cpu")
    rng = np.random.default_rng(3)
    depth = rng.uniform(1.0, 3.0, (h, w)).astype(np.float32)
    depth[5:9, 5:9] = 2.0  # a flat patch: exercises the zero-normal guard
    return [
        (jc.world_view, tc.world_view), (jc.full_proj, tc.full_proj),
        (jcam.projection(0.01, 100.0, 1.1, 0.8), tcam.projection(0.01, 100.0, 1.1, 0.8)),
        (jcam.ndc_to_pix(w, h, ja.znear, ja.zfar), tcam.ndc_to_pix(w, h, ta.znear, ta.zfar)),
        (jcam.view_to_pix_matrix(ja, w, h), tcam.view_to_pix_matrix(ta, w, h)),
        (jcam.depth_to_points(ja, jnp.asarray(depth), w, h) / 3.0,
         tcam.depth_to_points(ta, to_torch(depth), w, h) / 3.0),
        # central differences of neighbouring points cancel ~1.5 digits of
        # their float32 rounding: unit normals agree to ~2e-6
        (jcam.depth_to_normal(ja, jnp.asarray(depth), w, h),
         tcam.depth_to_normal(ta, to_torch(depth), w, h), 1e-5),
        (jcam.fov2focal(1.1, w), tcam.fov2focal(1.1, w)),
        *zip(ja, ta),
    ]


def _case_sh():
    rng = np.random.default_rng(4)
    sh = rng.normal(size=(64, 3, 25)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rgb = rng.uniform(size=(64, 3)).astype(np.float32)
    pairs = [(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d)),
              tsh.eval_sh(deg, to_torch(sh), to_torch(d))) for deg in range(5)]
    pairs.append((jsh.rgb_to_sh(jnp.asarray(rgb)), tsh.rgb_to_sh(to_torch(rgb))))
    pairs.append((jsh.sh_to_rgb(jnp.asarray(rgb)), tsh.sh_to_rgb(to_torch(rgb))))
    return pairs


def _case_transforms():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    s = rng.uniform(0.01, 1.0, (64, 2)).astype(np.float32)
    p = rng.uniform(0.05, 0.95, (64, 3)).astype(np.float32)
    pairs = [
        (jtf.normalize(jnp.asarray(q)), ttf.normalize(to_torch(q))),
        (jtf.quat_to_rotmat(jnp.asarray(q)), ttf.quat_to_rotmat(to_torch(q))),
        (jtf.homogenize(jnp.asarray(p)), ttf.homogenize(to_torch(p))),
        (jtf.inverse_sigmoid(jnp.asarray(p)), ttf.inverse_sigmoid(to_torch(p))),
    ]
    pairs += list(zip(jtf.splat_axes(jnp.asarray(s), jnp.asarray(q)),
                      ttf.splat_axes(to_torch(s), to_torch(q))))
    return pairs


def _case_preprocess():
    w, h = 96, 64
    scene = _random_scene(n=64, seed=7)
    live = np.arange(64) % 5 != 0
    js = jpre.preprocess(*scene, _cam(w, h), w, h, 3, live=jnp.asarray(live))
    ts = tpre.preprocess(*map(to_torch, scene), port_cam(w, h), w, h, 3,
                         live=to_torch(live))
    vis = np.asarray(js.visible)
    pairs = []
    for name in jpre.SplatScreen._fields:
        a, b = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
        if name == "depth":  # +inf where culled
            a, b = a[vis], b[vis]
        # screen quantities are in pixels: compare at pixel scale
        scale = 100.0 if name in ("tmat", "mean2d", "filter_center", "half_extent",
                                  "box_center", "box_half") else 1.0
        pairs.append((a / scale, b / scale))
    jm = japi.mark_visible(scene[0], _cam(w, h))
    tm = tapi.mark_visible(to_torch(scene[0]), port_cam(w, h))
    return pairs + [(jm, tm)]


CASES = {"cameras": _case_cameras, "sh": _case_sh,
         "transforms": _case_transforms, "preprocess": _case_preprocess}


@pytest.mark.parametrize("case", sorted(CASES))
def test_core_matches_jax(case):
    for i, (a, b, *tol) in enumerate(CASES[case]()):
        tol = tol[0] if tol else 1e-6
        a = np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.shape == b.shape, (case, i, a.shape, b.shape)
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=f"{case} #{i}")
        else:
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol, err_msg=f"{case} #{i}")


def test_port_imports_no_jax():
    """Every tpu2dgs_torch module imports without pulling in jax, any
    tpu2dgs module or pandas (the GPU machine has none; run in a fresh
    interpreter: conftest imports jax)."""
    code = (
        "import pkgutil, sys, importlib, tpu2dgs_torch\n"
        "for m in pkgutil.walk_packages(tpu2dgs_torch.__path__, 'tpu2dgs_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'tpu2dgs' or n.startswith('tpu2dgs.')\n"
        "       or n == 'pandas' or n.startswith('pandas.')]\n"
        "assert not bad, bad\n"
        "mods = {n for n in sys.modules if n.startswith('tpu2dgs_torch.')}\n"
        "want = {'tpu2dgs_torch.' + n for n in ('cli.config', 'cli.train', 'cli.render',\n"
        "        'cli.metrics', 'cli.convert', 'data.colmap', 'data.scene', 'data.paths',\n"
        "        'train.checkpoint', 'train.logging', 'native.knn', 'eval.bin_probe',\n"
        "        'eval.reduce_probe', 'eval.timing', 'mesh.marching', 'mesh.tsdf',\n"
        "        'mesh.extract', 'mesh.cull', 'eval.geometry', 'eval.trajectory',\n"
        "        'eval.tnt_scene', 'eval.dtu_scene', 'eval.mesh_profile', 'raster.blend',\n"
        "        'raster.oracle', 'raster.tiled', 'eval.quality_gate', 'parallel.distributed',\n"
        "        'parallel.sharded', 'parallel.rehearsal', 'viewer.network_gui',\n"
        "        'viewer.modes', 'cli.view', 'eval.lpips', 'eval.train_bench',\n"
        "        'eval.soak_train', 'eval.fidelity_probe', 'eval.capk_probe',\n"
        "        'eval.loss_probe', 'eval.strip_balance_probe', 'eval.nerf_eval',\n"
        "        'eval.m360_eval', 'eval.dtu_eval', 'eval.tnt_eval', 'eval.summary')}\n"
        "assert want <= mods, sorted(want - mods)\n"
        "print(len(mods))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout) >= 40  # every module of the package was imported


def test_default_device_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpu2dgs_torch.default_device()
    cam = tcam.Camera(uid=0, image_name="t", R=np.eye(3), T=np.zeros(3),
                      fovx=1.0, fovy=1.0, width=8, height=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        cam.arrays()
    assert tpu2dgs_torch.default_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
