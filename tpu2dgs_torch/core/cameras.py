"""Camera models and projective geometry (port of tpu2dgs/core/cameras.py).

All matrices use the ROW-VECTOR convention of the reference pipeline
(x_out = x_in_homogeneous @ M):

  world_view:  x_view  = x_world_h @ world_view
  full_proj:   x_clip  = x_world_h @ full_proj        (= world_view @ proj)
  ndc2pix:     x_pix_h = x_clip    @ ndc2pix          (homogeneous pixels)

`Camera` is a host-side (numpy) object holding per-view data;
`CameraArrays` holds the same view as tensors on one device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpu2dgs_torch import default_device

DEFAULT_ZNEAR = 0.01
DEFAULT_ZFAR = 100.0


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view(R: np.ndarray, t: np.ndarray, translate=None, scale: float = 1.0) -> np.ndarray:
    """Row-vector world->view matrix (COLMAP R = rotmat(qvec).T, t = tvec)."""
    if translate is None:
        translate = np.zeros(3)
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + translate) * scale
    C2W[:3, 3] = cam_center
    Rt = np.linalg.inv(C2W)
    return np.float32(Rt).T  # row-vector convention


def projection(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """Row-vector perspective projection (pinhole, centered principal point)."""
    tan_half_y = math.tan(fovy / 2.0)
    tan_half_x = math.tan(fovx / 2.0)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tan_half_x
    P[1, 1] = 1.0 / tan_half_y
    P[2, 2] = zfar / (zfar - znear)
    P[3, 2] = -(zfar * znear) / (zfar - znear)
    P[2, 3] = 1.0
    return P


def ndc_to_pix(width: int, height: int, znear: torch.Tensor, zfar: torch.Tensor) -> torch.Tensor:
    """Row-vector NDC->homogeneous-pixel matrix on znear's device.

    Pixel centers land at integer coordinates 0..W-1. No perspective
    divide: output is (x*w, y*w, z', w). float32, or znear's float dtype."""
    znear = torch.as_tensor(znear)
    dtype = znear.dtype if znear.is_floating_point() else torch.float32
    znear = znear.to(dtype)
    zfar = torch.as_tensor(zfar, dtype=dtype, device=znear.device)
    A = torch.zeros((4, 4), dtype=dtype, device=znear.device)
    A[0, 0] = width / 2.0
    A[0, 3] = (width - 1) / 2.0
    A[1, 1] = height / 2.0
    A[1, 3] = (height - 1) / 2.0
    A[2, 2] = zfar - znear
    A[2, 3] = znear
    A[3, 3] = 1.0
    return A.T


class CameraArrays(NamedTuple):
    """Tensor view of a camera on one device (image height/width live in
    RasterSettings)."""

    world_view: torch.Tensor  # (4,4) row-vector world->view
    full_proj: torch.Tensor   # (4,4) row-vector world->clip
    cam_center: torch.Tensor  # (3,)
    tanfovx: torch.Tensor     # ()
    tanfovy: torch.Tensor     # ()
    znear: torch.Tensor       # ()
    zfar: torch.Tensor        # ()

    def to(self, device) -> "CameraArrays":
        return CameraArrays(*(a.to(device) for a in self))


@dataclasses.dataclass
class Camera:
    """A posed view. Image data is kept on the host (numpy)."""

    uid: int
    image_name: str
    R: np.ndarray  # (3,3) COLMAP-convention rotation (= rotmat(qvec).T)
    T: np.ndarray  # (3,) COLMAP translation
    fovx: float
    fovy: float
    width: int
    height: int
    image: Optional[np.ndarray] = None       # (3,H,W) float32 in [0,1]
    alpha_mask: Optional[np.ndarray] = None  # (1,H,W) float32 or None
    znear: float = DEFAULT_ZNEAR
    zfar: float = DEFAULT_ZFAR
    trans: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0

    def __post_init__(self):
        self.world_view = world_to_view(self.R, self.T, self.trans, self.scale)
        self.proj = projection(self.znear, self.zfar, self.fovx, self.fovy)
        self.full_proj = self.world_view @ self.proj
        self.cam_center = np.linalg.inv(self.world_view)[3, :3]

    @property
    def tanfovx(self) -> float:
        return math.tan(self.fovx * 0.5)

    @property
    def tanfovy(self) -> float:
        return math.tan(self.fovy * 0.5)

    def arrays(self, device=None) -> CameraArrays:
        dev = default_device(device)

        def f32(x):
            return torch.as_tensor(np.float32(x), dtype=torch.float32, device=dev)

        return CameraArrays(
            world_view=f32(self.world_view),
            full_proj=f32(self.full_proj),
            cam_center=f32(self.cam_center),
            tanfovx=f32(self.tanfovx),
            tanfovy=f32(self.tanfovy),
            znear=f32(self.znear),
            zfar=f32(self.zfar),
        )


def view_to_pix_matrix(cam: CameraArrays, width: int, height: int) -> torch.Tensor:
    """(3,3) row-vector camera-space -> homogeneous-pixel matrix (the
    reference's half-pixel convention: offsets W/2, H/2)."""
    A = torch.tensor(
        [
            [width / 2.0, 0.0, 0.0, width / 2.0],
            [0.0, height / 2.0, 0.0, height / 2.0],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=cam.world_view.dtype, device=cam.world_view.device,
    ).T  # (4,3) row-vector ndc->pix(3)
    c2w = torch.linalg.inv(cam.world_view)
    view2clip = c2w @ cam.full_proj
    return (view2clip @ A)[:3, :3]  # x_pix_h = x_view @ K


def depth_to_points(cam: CameraArrays, depth: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Backproject a (H,W) depth map to world points (H,W,3)
    (point = depth * ray_d + origin, ray_d of unit view-z)."""
    dev = depth.device
    K = view_to_pix_matrix(cam, width, height)
    Kinv = torch.linalg.inv(K)
    xs = torch.arange(width, dtype=depth.dtype, device=dev)
    ys = torch.arange(height, dtype=depth.dtype, device=dev)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")  # (H,W)
    pix = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # (H,W,3)
    rays_view = pix @ Kinv
    c2w = torch.linalg.inv(cam.world_view)
    rays_world = rays_view @ c2w[:3, :3]
    origin = c2w[3, :3]
    return depth[..., None] * rays_world + origin


def depth_to_normal(cam: CameraArrays, depth: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Central-difference world-space normals of the backprojected depth
    map, (H,W,3); the border ring is zero."""
    pts = depth_to_points(cam, depth, width, height)
    dx = pts[2:, 1:-1] - pts[:-2, 1:-1]
    dy = pts[1:-1, 2:] - pts[1:-1, :-2]
    n = torch.linalg.cross(dx, dy, dim=-1)
    # F.normalize semantics (x / max(|x|, 1e-12)) with a gradient-safe
    # zero branch: the double where keeps sqrt's derivative off n2 == 0.
    n2 = torch.sum(n * n, dim=-1, keepdim=True)
    nonzero = n2 > 0.0
    norm = torch.sqrt(torch.where(nonzero, n2, 1.0))
    denom = torch.clamp(torch.where(nonzero, norm, 0.0), min=1e-12)
    n = n / denom
    out = torch.zeros_like(pts)
    out[1:-1, 1:-1, :] = n
    return out
