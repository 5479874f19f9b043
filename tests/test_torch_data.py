"""tpu2dgs_torch data layer against tpu2dgs: the same files on disk, written
with the JAX package's writers as tests/test_data.py writes them, read by
both packages.

What is copied must be equal (ids, names, sizes, R, T, image arrays,
points); what is computed in float32 on one side and float64 on the other
(a Blender cloud's colours) or by linear algebra (trajectory poses) is
held at rtol 1e-6 and 1e-5. The Blender scene, the resolution policy
and the image writers are tests/test_torch_data_formats.py's and
tests/test_torch_data_resolution.py's.
"""

import os

import numpy as np
import pytest

from tests.test_data import _make_colmap_dataset
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.data import colmap as jcolmap
from tpu2dgs.data import paths as jpaths
from tpu2dgs.data import scene as jscene
from tpu2dgs.model import splats as jsplats
from tpu2dgs_torch.core import cameras as tcam
from tpu2dgs_torch.data import colmap as tcolmap
from tpu2dgs_torch.data import paths as tpaths
from tpu2dgs_torch.data import scene as tscene


def _same_info(a, b):
    """One CameraInfo of each package: copied fields equal."""
    assert (a.uid, a.image_path, a.image_name, a.width, a.height, a.white_background) == \
        (b.uid, b.image_path, b.image_name, b.width, b.height, b.white_background)
    np.testing.assert_array_equal(a.R, b.R)
    np.testing.assert_array_equal(a.T, b.T)
    assert a.fovx == b.fovx and a.fovy == b.fovy


def _same_scene_info(t, j, color_rtol=0.0):
    assert len(t.train_cameras) == len(j.train_cameras)
    assert len(t.test_cameras) == len(j.test_cameras)
    for a, b in zip(t.train_cameras + t.test_cameras, j.train_cameras + j.test_cameras):
        _same_info(a, b)
    np.testing.assert_array_equal(t.points, j.points)
    np.testing.assert_allclose(t.colors, j.colors, rtol=color_rtol, atol=0.0)
    assert t.points.dtype == j.points.dtype == np.float32
    assert t.colors.dtype == j.colors.dtype == np.float32
    np.testing.assert_allclose(t.translate, j.translate, rtol=1e-6)
    np.testing.assert_allclose(t.radius, j.radius, rtol=1e-6)


def _same_camera(t, j):
    assert isinstance(t, tcam.Camera)
    assert (t.uid, t.image_name, t.width, t.height) == (j.uid, j.image_name, j.width, j.height)
    np.testing.assert_array_equal(t.R, j.R)
    np.testing.assert_array_equal(t.T, j.T)
    assert t.fovx == j.fovx and t.fovy == j.fovy
    assert t.image.dtype == np.float32 and t.image.shape == (3, t.height, t.width)
    np.testing.assert_array_equal(t.image, j.image)
    assert (t.alpha_mask is None) == (j.alpha_mask is None)
    if t.alpha_mask is not None:
        np.testing.assert_array_equal(t.alpha_mask, j.alpha_mask)
    np.testing.assert_array_equal(t.world_view, j.world_view)
    np.testing.assert_array_equal(t.full_proj, j.full_proj)


@pytest.fixture(scope="module", params=["binary", "text"])
def colmap_root(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(request.param) / "scene")
    os.makedirs(root)
    xyz, rgb = _make_colmap_dataset(root, n_views=6, n_pts=40, binary=request.param == "binary")
    return root, xyz, rgb


def test_colmap_scene_matches_jax(colmap_root):
    root, xyz, rgb = colmap_root
    for eval_split in (False, True):
        t = tscene.read_scene(root, eval_split=eval_split)
        _same_scene_info(t, jscene.read_scene(root, eval_split=eval_split))
    assert len(t.train_cameras) == 5 and len(t.test_cameras) == 1
    np.testing.assert_allclose(t.points, xyz, atol=1e-6)
    np.testing.assert_allclose(t.colors, rgb / 255.0, atol=1e-6)
    for ti, ji in zip(t.train_cameras, jscene.read_scene(root, eval_split=True).train_cameras):
        for resolution in (1, 2, 32):
            _same_camera(tscene.load_camera(ti, resolution=resolution),
                         jscene.load_camera(ji, resolution=resolution))
    assert tscene.load_camera(t.train_cameras[0], resolution=2).image.shape == (3, 24, 32)
    # a folder that is neither a COLMAP nor a Blender scene is refused
    with pytest.raises(ValueError, match="could not recognize"):
        tscene.read_scene(os.path.dirname(root))


def test_scene_load_matches_jax(colmap_root, tmp_path):
    root, _, _ = colmap_root
    t = tscene.Scene.load(root, resolution=1, eval_split=True, shuffle=True, seed=3)
    j = jscene.Scene.load(root, resolution=1, eval_split=True, shuffle=True, seed=3)
    assert [c.image_name for c in t.train_cameras] == [c.image_name for c in j.train_cameras]
    assert [c.image_name for c in t.train_cameras] != sorted(c.image_name
                                                             for c in t.train_cameras)
    for a, b in zip(t.train_cameras + t.test_cameras, j.train_cameras + j.test_cameras):
        _same_camera(a, b)
    np.testing.assert_allclose(t.extent, j.extent, rtol=1e-6)
    assert t.get_train_cameras(2.0) is t.train_cameras  # an unloaded scale: the default list

    # cameras.json entries and the model directory's scene files
    for cid, (a, b) in enumerate(zip(t.train_cameras, j.train_cameras)):
        assert tscene.camera_to_json(cid, a) == jscene.camera_to_json(cid, b)
    t.save_model_info(str(tmp_path / "t"))
    j.save_model_info(str(tmp_path / "j"))
    for name in ("input.ply", "cameras.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    vv = jsplats.read_ply_vertices(str(tmp_path / "t" / "input.ply"))
    np.testing.assert_array_equal(vv["x"], t.points[:, 0])

    # a trajectory through the training views
    tp = tpaths.generate_path(t.train_cameras, n_frames=12)
    jp = jpaths.generate_path(j.train_cameras, n_frames=12)
    assert len(tp) == len(jp) == 12 and isinstance(tp[0], tcam.Camera)
    for a, b in zip(tp, jp):
        assert (a.image_name, a.width, a.height, a.fovx) == (b.image_name, b.width, b.height,
                                                             b.fovx)
        np.testing.assert_allclose(a.R, b.R, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(a.T, b.T, rtol=1e-5, atol=1e-7)


def test_port_writers_read_by_jax(colmap_root, tmp_path):
    """The files the port writes (what its smoke run trains on) in the JAX
    package's readers, and in its own."""
    root, xyz, rgb = colmap_root
    sparse = os.path.join(root, "sparse", "0")
    if os.path.exists(os.path.join(sparse, "cameras.bin")):
        cams = tcolmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
        images = tcolmap.read_images_binary(os.path.join(sparse, "images.bin"))
    else:
        cams = tcolmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))
        images = tcolmap.read_images_text(os.path.join(sparse, "images.txt"))
    out = str(tmp_path)
    tcolmap.write_cameras_binary(cams, os.path.join(out, "cameras.bin"))
    tcolmap.write_images_binary(images, os.path.join(out, "images.bin"))
    tcolmap.write_points3d_binary(xyz, rgb, os.path.join(out, "points3D.bin"))

    for mod in (jcolmap, tcolmap):
        cams2 = mod.read_cameras_binary(os.path.join(out, "cameras.bin"))
        images2 = mod.read_images_binary(os.path.join(out, "images.bin"))
        xyz2, rgb2, err2 = mod.read_points3d_binary(os.path.join(out, "points3D.bin"))
        assert set(cams2) == set(cams) and set(images2) == set(images)
        for k, c in cams.items():
            assert cams2[k][:4] == c[:4]
            np.testing.assert_array_equal(cams2[k].params, c.params)
        for k, im in images.items():
            assert (images2[k].id, images2[k].camera_id, images2[k].name) == \
                (im.id, im.camera_id, im.name)
            np.testing.assert_array_equal(images2[k].qvec, im.qvec)
            np.testing.assert_array_equal(images2[k].tvec, im.tvec)
        np.testing.assert_array_equal(xyz2, xyz)
        np.testing.assert_array_equal(rgb2, rgb)
        assert err2.shape == (40,)
    q = images[1].qvec
    np.testing.assert_allclose(tcolmap.rotmat2qvec(tcolmap.qvec2rotmat(q)), q, atol=1e-12)
    np.testing.assert_array_equal(tcolmap.qvec2rotmat(q), jcolmap.qvec2rotmat(q))
