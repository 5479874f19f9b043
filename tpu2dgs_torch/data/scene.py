"""Scene loading: COLMAP + Blender datasets -> posed cameras + seed points
(port of tpu2dgs/data/scene.py).

Behavior parity with reference scene/dataset_readers.py + scene/__init__.py +
utils/camera_utils.py:
  * dataset type detection: `sparse/` => COLMAP, `transforms_train.json` =>
    Blender (scene/__init__.py:43-49),
  * COLMAP: SIMPLE_PINHOLE / PINHOLE intrinsics only, cameras sorted by image
    name, llffhold=8 eval split (dataset_readers.py:132-177),
  * Blender: OpenGL->COLMAP axis flip, RGBA composited over white/black
    background, random 100K-point init in [-1.3, 1.3]^3
    (dataset_readers.py:180-255),
  * NeRF++ normalization: radius = 1.1 * max distance from mean camera
    center (dataset_readers.py:45-66),
  * resolution policy incl. the >1600px auto-downscale
    (utils/camera_utils.py:19-39).

Host-side only (numpy + PIL); images are float32 (3,H,W) arrays in [0,1]
and live in host memory until the Trainer stages them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import NamedTuple, Optional

import numpy as np

from tpu2dgs_torch.core import cameras as cameras_lib
from tpu2dgs_torch.core.cameras import focal2fov, fov2focal


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray
    T: np.ndarray
    fovx: float
    fovy: float
    image_path: str
    image_name: str
    width: int
    height: int
    white_background: bool = False


class SceneInfo(NamedTuple):
    points: Optional[np.ndarray]   # (N,3)
    colors: Optional[np.ndarray]   # (N,3) in [0,1]
    train_cameras: list
    test_cameras: list
    translate: np.ndarray
    radius: float


def nerfpp_norm(cam_infos: list[CameraInfo]):
    """NeRF++-style scene normalization (dataset_readers.py:45-66)."""
    centers = []
    for c in cam_infos:
        w2v = cameras_lib.world_to_view(c.R, c.T)  # row-vector
        centers.append(np.linalg.inv(w2v)[3, :3])
    centers = np.stack(centers)
    center = centers.mean(axis=0)
    radius = float(np.linalg.norm(centers - center, axis=1).max()) * 1.1
    return -center, radius


def read_colmap_scene(path: str, images_dir: Optional[str] = None,
                      eval_split: bool = False, llffhold: int = 8) -> SceneInfo:
    from tpu2dgs_torch.data import colmap

    sparse = os.path.join(path, "sparse", "0")
    if os.path.exists(os.path.join(sparse, "images.bin")):
        extr = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    else:
        extr = colmap.read_images_text(os.path.join(sparse, "images.txt"))
        intr = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    reading_dir = images_dir or "images"
    infos = []
    for im in extr.values():
        cam = intr[im.camera_id]
        if cam.model == "SIMPLE_PINHOLE":
            fx = fy = cam.params[0]
        elif cam.model == "PINHOLE":
            fx, fy = cam.params[0], cam.params[1]
        else:
            raise ValueError(
                f"COLMAP camera model {cam.model} not supported: undistort "
                "first (PINHOLE / SIMPLE_PINHOLE only, as the reference)"
            )
        image_path = os.path.join(path, reading_dir, os.path.basename(im.name))
        infos.append(CameraInfo(
            uid=cam.id,
            R=colmap.qvec2rotmat(im.qvec).T,
            T=np.array(im.tvec),
            fovx=focal2fov(fx, cam.width),
            fovy=focal2fov(fy, cam.height),
            image_path=image_path,
            image_name=os.path.basename(image_path).split(".")[0],
            width=cam.width, height=cam.height,
        ))
    infos.sort(key=lambda c: c.image_name)

    if eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []

    translate, radius = nerfpp_norm(train)

    if os.path.exists(os.path.join(sparse, "points3D.bin")):
        xyz, rgb, _ = colmap.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
    else:
        xyz, rgb, _ = colmap.read_points3d_text(os.path.join(sparse, "points3D.txt"))
    return SceneInfo(
        points=xyz.astype(np.float32),
        colors=(rgb.astype(np.float32) / 255.0),
        train_cameras=train, test_cameras=test,
        translate=translate, radius=radius,
    )


def _read_transforms(path: str, fname: str, white_background: bool,
                     extension: str = ".png") -> list[CameraInfo]:
    with open(os.path.join(path, fname)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    infos = []
    for idx, frame in enumerate(contents["frames"]):
        file_path = frame["file_path"]
        if not os.path.splitext(file_path)[1]:
            file_path = file_path + extension
        image_path = os.path.join(path, file_path)
        # OpenGL/Blender (Y up, Z back) -> COLMAP (Y down, Z forward)
        c2w = np.array(frame["transform_matrix"], dtype=np.float64)
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        from PIL import Image

        with Image.open(image_path) as im:
            w, h = im.size
        infos.append(CameraInfo(
            uid=idx,
            R=w2c[:3, :3].T,
            T=w2c[:3, 3],
            fovx=fovx,
            fovy=focal2fov(fov2focal(fovx, w), h),
            image_path=image_path,
            image_name=os.path.splitext(os.path.basename(image_path))[0],
            width=w, height=h,
            white_background=white_background,
        ))
    return infos


def read_blender_scene(path: str, white_background: bool = False,
                       eval_split: bool = False,
                       num_init_points: int = 100_000,
                       seed: int = 0) -> SceneInfo:
    train = _read_transforms(path, "transforms_train.json", white_background)
    test = (
        _read_transforms(path, "transforms_test.json", white_background)
        if os.path.exists(os.path.join(path, "transforms_test.json")) else []
    )
    if not eval_split:
        train = train + test
        test = []
    translate, radius = nerfpp_norm(train)
    rng = np.random.default_rng(seed)
    xyz = (rng.random((num_init_points, 3)) * 2.6 - 1.3).astype(np.float32)
    # colors near mid-gray, as the reference's random SH init
    # (dataset_readers.py:241: SH2RGB of U[0, 1/255])
    from tpu2dgs_torch.core import sh as sh_lib

    colors = sh_lib.sh_to_rgb(rng.random((num_init_points, 3)) / 255.0)
    return SceneInfo(
        points=xyz, colors=colors.astype(np.float32),
        train_cameras=train, test_cameras=test,
        translate=translate, radius=radius,
    )


def read_scene(path: str, images_dir: Optional[str] = None,
               white_background: bool = False,
               eval_split: bool = False,
               num_init_points: Optional[int] = None) -> SceneInfo:
    """Dataset-type dispatch (reference scene/__init__.py:43-49).

    `num_init_points` overrides the Blender random-init cloud size (the
    reference hardcodes 100K, dataset_readers.py:236-244; a small value
    exercises capacity growth — used by scripts/quality_gate.py --soak)."""
    if os.path.exists(os.path.join(path, "sparse")):
        return read_colmap_scene(path, images_dir, eval_split)
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        kw = ({} if num_init_points is None
              else {"num_init_points": num_init_points})
        return read_blender_scene(path, white_background, eval_split, **kw)
    raise ValueError(f"could not recognize scene type at {path!r}")


# -- camera materialization --------------------------------------------------


def _target_resolution(orig_w: int, orig_h: int, resolution: int,
                       resolution_scale: float = 1.0):
    """Reference resolution policy (utils/camera_utils.py:19-39)."""
    if resolution in (1, 2, 4, 8):
        return (
            round(orig_w / (resolution_scale * resolution)),
            round(orig_h / (resolution_scale * resolution)),
        )
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1.0
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def load_camera(info: CameraInfo, resolution: int = -1,
                resolution_scale: float = 1.0) -> cameras_lib.Camera:
    """CameraInfo -> Camera with the image loaded, resized, composited.

    RGBA images keep the alpha channel as `alpha_mask` and are composited
    over the scene background (reference cameras.py:43-48 multiplies gt by
    the mask; Blender reader pre-composites — both behaviors preserved)."""
    from PIL import Image

    with Image.open(info.image_path) as pil:
        w, h = _target_resolution(pil.width, pil.height, resolution,
                                  resolution_scale)
        pil = pil.resize((w, h))
        arr = np.asarray(pil, dtype=np.float32) / 255.0

    alpha_mask = None
    if arr.ndim == 3 and arr.shape[2] == 4:
        alpha = arr[:, :, 3:4]
        bg = 1.0 if info.white_background else 0.0
        rgb = arr[:, :, :3] * alpha + bg * (1.0 - alpha)
        alpha_mask = alpha.transpose(2, 0, 1)
    elif arr.ndim == 2:
        rgb = np.repeat(arr[:, :, None], 3, axis=2)
    else:
        rgb = arr[:, :, :3]

    return cameras_lib.Camera(
        uid=info.uid, image_name=info.image_name,
        R=info.R, T=info.T, fovx=info.fovx, fovy=info.fovy,
        width=w, height=h,
        image=np.ascontiguousarray(rgb.transpose(2, 0, 1)),
        alpha_mask=alpha_mask,
    )


@dataclasses.dataclass
class Scene:
    """Assembled scene: cameras + seed point cloud + normalization.

    The reference `Scene` also owns the model; here they are decoupled —
    create the model with `splats.create_from_pcd(scene.points, ...)`.

    `train_cameras`/`test_cameras` are the resolution_scale=1.0 lists; other
    scales requested at load time are available via `get_train_cameras` /
    `get_test_cameras` (reference scene/__init__.py:25,71)."""

    info: SceneInfo
    train_cameras: list
    test_cameras: list
    train_by_scale: dict = dataclasses.field(default_factory=dict)
    test_by_scale: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def load(cls, path: str, images_dir: Optional[str] = None,
             resolution: int = -1, white_background: bool = False,
             eval_split: bool = False, shuffle: bool = True,
             seed: int = 0, resolution_scales=(1.0,),
             num_init_points: Optional[int] = None) -> "Scene":
        info = read_scene(path, images_dir, white_background, eval_split,
                          num_init_points=num_init_points)
        train_by_scale, test_by_scale = {}, {}
        rng = np.random.default_rng(seed)
        order = None
        for scale in resolution_scales:
            train = [load_camera(c, resolution, scale)
                     for c in info.train_cameras]
            if shuffle:
                if order is None:  # same shuffle across scales
                    order = rng.permutation(len(train))
                train = [train[i] for i in order]
            train_by_scale[scale] = train
            test_by_scale[scale] = [load_camera(c, resolution, scale)
                                    for c in info.test_cameras]
        first = resolution_scales[0] if 1.0 not in train_by_scale else 1.0
        return cls(info=info,
                   train_cameras=train_by_scale[first],
                   test_cameras=test_by_scale[first],
                   train_by_scale=train_by_scale,
                   test_by_scale=test_by_scale)

    def get_train_cameras(self, scale: float = 1.0) -> list:
        return self.train_by_scale.get(scale, self.train_cameras)

    def get_test_cameras(self, scale: float = 1.0) -> list:
        return self.test_by_scale.get(scale, self.test_cameras)

    def save_model_info(self, model_path: str) -> None:
        """Write `input.ply` + `cameras.json` into the model directory.

        Ecosystem viewers and the reference's own tooling read these on
        fresh trainings (reference scene/__init__.py:50-62)."""
        os.makedirs(model_path, exist_ok=True)
        if self.points is not None:
            store_ply(os.path.join(model_path, "input.ply"),
                      self.points, self.colors)
        json_cams = []
        camlist = list(self.test_cameras) + list(self.train_cameras)
        for cid, cam in enumerate(camlist):
            json_cams.append(camera_to_json(cid, cam))
        with open(os.path.join(model_path, "cameras.json"), "w") as f:
            json.dump(json_cams, f)

    @property
    def extent(self) -> float:
        return self.info.radius

    @property
    def points(self) -> np.ndarray:
        return self.info.points

    @property
    def colors(self) -> np.ndarray:
        return self.info.colors


def camera_to_json(cid: int, cam) -> dict:
    """Reference utils/camera_utils.py:64-83 JSON camera entry."""
    rt = np.zeros((4, 4))
    rt[:3, :3] = cam.R.transpose()
    rt[:3, 3] = cam.T
    rt[3, 3] = 1.0
    w2c = np.linalg.inv(rt)
    pos = w2c[:3, 3]
    rot = w2c[:3, :3]
    return {
        "id": cid,
        "img_name": cam.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": pos.tolist(),
        "rotation": [x.tolist() for x in rot],
        "fy": fov2focal(cam.fovy, cam.height),
        "fx": fov2focal(cam.fovx, cam.width),
    }


def store_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Binary PLY with the reference storePly attribute layout
    (dataset_readers.py:115-130): x,y,z,nx,ny,nz,red,green,blue."""
    n = xyz.shape[0]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    dtype = np.dtype([
        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
        ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
        ("red", "u1"), ("green", "u1"), ("blue", "u1"),
    ])
    rec = np.zeros(n, dtype=dtype)
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    col = np.clip(np.asarray(rgb) * 255.0, 0, 255).astype(np.uint8)
    rec["red"], rec["green"], rec["blue"] = col[:, 0], col[:, 1], col[:, 2]
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())
