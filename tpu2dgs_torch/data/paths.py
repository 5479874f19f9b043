"""Novel camera trajectories + video export (port of tpu2dgs/data/paths.py;
numpy only).

Reference utils/render_utils.py (multinerf-derived): PCA pose normalization
(line 76), focus point (68), ellipse path (121), generate_path (173),
create_videos (203). mediapy/ffmpeg are optional: frames are always written
as PNGs; video encoding happens only if ffmpeg is on PATH.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

import numpy as np

from tpu2dgs_torch.core.cameras import Camera


def normalize(x):
    return x / np.linalg.norm(x)


def viewmatrix(lookdir, up, position):
    """Camera-to-world from viewing direction (reference render_utils.py:55)."""
    vec2 = normalize(lookdir)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def focus_point_fn(poses):
    """Nearest point to all camera axes (reference render_utils.py:62-71)."""
    directions, origins = poses[:, :3, 2:3], poses[:, :3, 3:4]
    m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
    mt_m = np.transpose(m, [0, 2, 1]) @ m
    return np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]


def transform_poses_pca(poses):
    """Rotate/translate/scale poses into their PCA frame
    (reference render_utils.py:76-118). Returns (new_poses, transform 4x4)."""
    t = poses[:, :3, 3]
    t_mean = t.mean(axis=0)
    t = t - t_mean
    eigval, eigvec = np.linalg.eig(t.T @ t)
    inds = np.argsort(eigval)[::-1]
    eigvec = eigvec[:, inds]
    rot = eigvec.T
    if np.linalg.det(rot) < 0:
        rot = np.diag(np.array([1, 1, -1])) @ rot
    transform = np.concatenate([rot, rot @ -t_mean[:, None]], axis=-1)
    poses_recentered = unpad_poses(transform @ pad_poses(poses))
    transform = np.concatenate([transform, np.eye(4)[3:]], axis=0)
    if poses_recentered.mean(axis=0)[2, 1] < 0:
        poses_recentered = np.diag(np.array([1, -1, -1])) @ poses_recentered
        transform = np.diag(np.array([1, -1, -1, 1])) @ transform
    scale_factor = 1.0 / np.max(np.abs(poses_recentered[:, :3, 3]))
    poses_recentered[:, :3, 3] *= scale_factor
    transform = np.diag(np.array([scale_factor] * 3 + [1])) @ transform
    return poses_recentered, transform


def pad_poses(p):
    bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
    return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def unpad_poses(p):
    return p[..., :3, :4]


def generate_ellipse_path(poses, n_frames=120, z_variation=0.0,
                          z_phase=0.0):
    """Elliptical path around the focus point (reference
    render_utils.py:121-171)."""
    center = focus_point_fn(poses)
    offset = np.array([center[0], center[1], 0])
    sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
    low = -sc + offset
    high = sc + offset
    z_low = np.percentile((poses[:, :3, 3]), 10, axis=0)
    z_high = np.percentile((poses[:, :3, 3]), 90, axis=0)

    def get_positions(theta):
        return np.stack([
            low[0] + (high - low)[0] * (np.cos(theta) * 0.5 + 0.5),
            low[1] + (high - low)[1] * (np.sin(theta) * 0.5 + 0.5),
            z_variation * (z_low[2] + (z_high - z_low)[2] *
                           (np.cos(theta + 2 * np.pi * z_phase) * 0.5 + 0.5)),
        ], -1)

    theta = np.linspace(0, 2.0 * np.pi, n_frames + 1, endpoint=True)
    positions = get_positions(theta)
    avg_up = poses[:, :3, 1].mean(0)
    avg_up = avg_up / np.linalg.norm(avg_up)
    ind_up = np.argmax(np.abs(avg_up))
    up = np.eye(3)[ind_up] * np.sign(avg_up[ind_up])
    return np.stack(
        [viewmatrix(p - center, up, p) for p in positions[:-1]]
    )


def generate_path(viewpoint_cameras: list[Camera], n_frames=480) -> list[Camera]:
    """Smooth novel path from training cameras (reference
    render_utils.py:173-200)."""
    c2ws = np.stack([
        np.linalg.inv(np.asarray(cam.world_view).T) for cam in viewpoint_cameras
    ])
    pose = c2ws[:, :3, :] @ np.diag([1, -1, -1, 1])
    pose_recenter, colmap_to_world_transform = transform_poses_pca(pose)
    new_poses = generate_ellipse_path(pose_recenter, n_frames=n_frames)
    new_poses = np.linalg.inv(colmap_to_world_transform) @ pad_poses(new_poses)

    ref = viewpoint_cameras[0]
    out = []
    for i, p in enumerate(new_poses):
        c2w = pad_poses(p[None, :3, :] @ np.diag([1, -1, -1, 1]))[0]
        w2c = np.linalg.inv(c2w)
        out.append(Camera(
            uid=i, image_name=f"path_{i:05d}",
            R=w2c[:3, :3].T, T=w2c[:3, 3],
            fovx=ref.fovx, fovy=ref.fovy,
            width=ref.width, height=ref.height,
        ))
    return out


def save_img_u8(img_hwc: np.ndarray, path: str) -> None:
    """(H,W,3) float [0,1] -> PNG (reference render_utils.py:270)."""
    from PIL import Image

    Image.fromarray(
        (np.clip(img_hwc, 0.0, 1.0) * 255.0).round().astype(np.uint8)
    ).save(path)


def save_img_f32(depth_hw: np.ndarray, path: str) -> None:
    """(H,W) float -> 32-bit TIFF (reference render_utils.py:278)."""
    from PIL import Image

    Image.fromarray(np.asarray(depth_hw, np.float32), mode="F").save(path)


def create_videos(frames_dir: str, out_path: str, fps: int = 30) -> Optional[str]:
    """Encode <frames_dir>/*.png into an mp4 if ffmpeg exists (the reference
    uses mediapy/h264, render_utils.py:203-268). Returns the path or None."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        print("ffmpeg not found; frames left as PNGs in", frames_dir)
        return None
    cmd = [ffmpeg, "-y", "-framerate", str(fps), "-pattern_type", "glob",
           "-i", os.path.join(frames_dir, "*.png"),
           "-c:v", "libx264", "-pix_fmt", "yuv420p", out_path]
    subprocess.run(cmd, check=True, capture_output=True)
    return out_path
