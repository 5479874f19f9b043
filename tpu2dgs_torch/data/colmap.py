"""COLMAP sparse-reconstruction parsers and writers, binary + text (the
port's own copy of tpu2dgs/data/colmap.py).

Same on-disk formats the reference consumes (scene/colmap_loader.py:125-294;
the formats themselves are COLMAP's public serialization). Pure
numpy/struct, host-side only.
"""

from __future__ import annotations

import os
import struct
from typing import NamedTuple

import numpy as np

# COLMAP camera model id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray  # (4,) wxyz
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray        # (M,2)
    point3d_ids: np.ndarray  # (M,)


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """(4,) wxyz -> (3,3) (reference scene/colmap_loader.py:43-55)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """(3,3) -> (4,) wxyz (largest-eigenvector method, matching COLMAP)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            out[cam_id] = ColmapCamera(cam_id, name, int(width), int(height), params)
    return out


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            vals = _read(f, "<idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            data = np.frombuffer(
                f.read(24 * n_pts), dtype=np.dtype([("xy", "<f8", 2), ("id", "<i8")])
            )
            out[image_id] = ColmapImage(
                image_id, qvec, tvec, camera_id, name.decode("utf-8"),
                np.array(data["xy"]), np.array(data["id"]),
            )
    return out


def read_points3d_binary(path: str):
    """Returns (xyz (N,3) f64, rgb (N,3) u8, error (N,) f64)."""
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        xyz = np.empty((num, 3))
        rgb = np.empty((num, 3), np.uint8)
        err = np.empty((num,))
        for i in range(num):
            vals = _read(f, "<QdddBBBd")
            xyz[i] = vals[1:4]
            rgb[i] = vals[4:7]
            err[i] = vals[7]
            (track_len,) = _read(f, "<Q")
            f.seek(8 * track_len, os.SEEK_CUR)
    return xyz, rgb, err


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            cam_id = int(tok[0])
            out[cam_id] = ColmapCamera(
                cam_id, tok[1], int(tok[2]), int(tok[3]),
                np.array([float(v) for v in tok[4:]]),
            )
    return out


def read_images_text(path: str) -> dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        # keep empty lines: each image is exactly (meta line, points2D line)
        # and the points2D line may be empty
        lines = [l.strip() for l in f if not l.strip().startswith("#")]
    while lines and not lines[-1] and len(lines) % 2 == 1:
        lines.pop()
    if len(lines) % 2 == 1:
        lines.append("")  # final image with no points2D and no trailing line
    for meta, pts in zip(lines[0::2], lines[1::2]):
        tok = meta.split()
        image_id = int(tok[0])
        qvec = np.array([float(v) for v in tok[1:5]])
        tvec = np.array([float(v) for v in tok[5:8]])
        camera_id = int(tok[8])
        name = tok[9]
        ptok = pts.split()
        xys = np.array(
            [[float(x), float(y)] for x, y in zip(ptok[0::3], ptok[1::3])]
        ).reshape(-1, 2)
        ids = np.array([int(v) for v in ptok[2::3]], dtype=np.int64)
        out[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name, xys, ids)
    return out


def read_points3d_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            xyz.append([float(v) for v in tok[1:4]])
            rgb.append([int(v) for v in tok[4:7]])
            err.append(float(tok[7]))
    return (
        np.array(xyz, np.float64).reshape(-1, 3),
        np.array(rgb, np.uint8).reshape(-1, 3),
        np.array(err, np.float64),
    )


# -- writers (used by tests and the convert pipeline) -----------------------


def write_cameras_binary(cams: dict[int, ColmapCamera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid = MODEL_NAME_TO_ID[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_binary(images: dict[int, ColmapImage], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack(
                "<idddddddi", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.point3d_ids)))
            for xy, pid in zip(im.xys, im.point3d_ids):
                f.write(struct.pack("<ddq", xy[0], xy[1], pid))


def write_points3d_binary(xyz: np.ndarray, rgb: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", xyz.shape[0]))
        for i in range(xyz.shape[0]):
            f.write(struct.pack(
                "<QdddBBBd", i, *xyz[i], *rgb[i].astype(np.uint8), 0.0))
            f.write(struct.pack("<Q", 0))
