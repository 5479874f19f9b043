"""tpu2dgs_torch data layer against tpu2dgs, continued from
tests/test_torch_data.py: a Blender (NeRF-synthetic) scene written here
and read by both packages (colours at rtol 1e-6: sh_to_rgb in float64 on
one side, float32 on the other), half of the resolution policy's cases
(the rest are tests/test_torch_data_resolution.py's), and the image
writers cli.render uses."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_data import _same_camera, _same_scene_info
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.data import paths as jpaths
from tpu2dgs.data import scene as jscene
from tpu2dgs_torch.data import paths as tpaths
from tpu2dgs_torch.data import scene as tscene

# (width, height, resolution flag[, resolution scale]): both packages'
# _target_resolution, in halves over this file and the next
RESOLUTIONS = [
    (1600, 1200, 2), (1600, 1200, 8), (1600, 1200, -1), (3200, 2400, -1), (1000, 500, 400),
    (1601, 1200, -1), (779, 519, 4), (1600, 1200, 2, 2.0)]


def test_blender_scene_matches_jax(tmp_path):
    root = str(tmp_path / "lego")
    os.makedirs(root)
    frames = []
    for i in range(4):
        ang = np.pi * i / 2
        fwd_gl = np.array([np.sin(ang), 0, np.cos(ang)])
        right = np.cross([0.0, 1.0, 0.0], fwd_gl)
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = (
            right, np.cross(fwd_gl, right), fwd_gl, 3.0 * fwd_gl)
        img = np.zeros((32, 32, 4), np.uint8)
        img[:, :, 0] = 200
        img[8:24, 8:24, 3] = 255  # center opaque, border transparent
        Image.fromarray(img).save(os.path.join(root, f"r_{i}.png"))
        frames.append({"file_path": f"r_{i}", "transform_matrix": c2w.tolist()})
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    with open(os.path.join(root, "transforms_test.json"), "w") as f:
        json.dump({"camera_angle_x": 0.8, "frames": frames[:1]}, f)

    for eval_split in (False, True):
        t = tscene.read_scene(root, white_background=True, eval_split=eval_split,
                              num_init_points=500)
        j = jscene.read_scene(root, white_background=True, eval_split=eval_split,
                              num_init_points=500)
        # colours: sh_to_rgb in float64 here, in float32 there
        _same_scene_info(t, j, color_rtol=1e-6)
    assert len(t.train_cameras) == 4 and len(t.test_cameras) == 1
    assert t.points.shape == (500, 3) and np.all(np.abs(t.points) <= 1.3)
    assert tscene.read_scene(root).points.shape == (100_000, 3)  # the reference's cloud

    for white in (True, False):
        ti = t.train_cameras[0]._replace(white_background=white)
        ji = j.train_cameras[0]._replace(white_background=white)
        cam = tscene.load_camera(ti, resolution=1)
        _same_camera(cam, jscene.load_camera(ji, resolution=1))
        np.testing.assert_allclose(cam.image[:, 0, 0], 1.0 if white else 0.0, atol=1e-6)
        assert cam.alpha_mask[0, 0, 0] == 0.0 and cam.alpha_mask[0, 16, 16] == 1.0


@pytest.mark.parametrize("args", RESOLUTIONS[:4])
def test_resolution_policy_matches_jax(args):
    assert tscene._target_resolution(*args) == jscene._target_resolution(*args)


def test_image_writers(tmp_path):
    """PNG and float TIFF as cli.render writes them, read back."""
    rng = np.random.default_rng(2)
    img = rng.random((12, 20, 3)).astype(np.float32)
    depth = rng.random((12, 20)).astype(np.float32) * 7.0
    for mod, name in ((tpaths, "t"), (jpaths, "j")):
        mod.save_img_u8(img, str(tmp_path / f"{name}.png"))
        mod.save_img_f32(depth, str(tmp_path / f"{name}.tiff"))
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    with Image.open(tmp_path / "t.tiff") as im:
        np.testing.assert_array_equal(np.asarray(im), depth)
    with Image.open(tmp_path / "j.tiff") as im:
        np.testing.assert_array_equal(np.asarray(im), depth)
    assert tpaths.create_videos(str(tmp_path), str(tmp_path / "v.mp4")) is None \
        or os.path.exists(tmp_path / "v.mp4")
