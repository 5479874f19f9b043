"""Projective TSDF fusion in PyTorch — bounded and contracted (unbounded)
(port of tpu2dgs/mesh/tsdf.py).

Replaces the reference's Open3D `ScalableTSDFVolume` (bounded path,
utils/mesh_utils.py:156-181). The volume lives on one device; a view is
fused into it in place, one block of x-slabs at a time, under no_grad, so
the device holds one volume plus one block's temporaries (the JAX package
builds a new volume per view).

Conventions match the reference:
  * sdf = sampled_depth - voxel_view_z (projective, not euclidean),
  * voxels with sdf < -sdf_trunc from a view are unobserved by that view,
  * tsdf = clip(sdf / sdf_trunc, -1, 1), weight-1 running average,
  * unbounded: voxels live in contracted space (mip-nerf-360 contraction),
    adaptive truncation sdf_trunc *= 1/(2-|x|) outside the unit sphere
    (mesh_utils.py:239-246).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu2dgs_torch import default_device
from tpu2dgs_torch.core.cameras import CameraArrays, view_to_pix_matrix

# x-slabs fused per step of `integrate`: the temporaries of a step scale
# with its voxels (16 slabs of a 1025^2 grid: 16.8M), the volume does not.
SLAB_BLOCK = 16


class TSDFVolume(NamedTuple):
    tsdf: torch.Tensor    # (NX, NY, NZ)
    weight: torch.Tensor  # (NX, NY, NZ)
    color: torch.Tensor   # (NX, NY, NZ, 3)
    origin: np.ndarray    # (3,)
    voxel: float


def make_volume(origin, dims, voxel: float, device=None) -> TSDFVolume:
    dev = default_device(device)
    nx, ny, nz = dims
    return TSDFVolume(
        tsdf=torch.zeros((nx, ny, nz), dtype=torch.float32, device=dev),
        weight=torch.zeros((nx, ny, nz), dtype=torch.float32, device=dev),
        color=torch.zeros((nx, ny, nz, 3), dtype=torch.float32, device=dev),
        origin=np.asarray(origin, np.float32),
        voxel=float(voxel),
    )


def _sample_nearest(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """img (H,W[,C]) sampled at float pixel coords; returns values + in-bounds
    mask (nearest neighbor, like Open3D's integrate). torch.round rounds
    half to even, as jnp.round does."""
    h, w = img.shape[:2]
    # Clamped to one pixel outside the image before the integer cast, which
    # keeps the in-bounds test and leaves no float out of int32's range.
    xi = torch.round(x).clamp(-1, w).to(torch.int64)
    yi = torch.round(y).clamp(-1, h).to(torch.int64)
    inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    xi = torch.clamp(xi, 0, w - 1)
    yi = torch.clamp(yi, 0, h - 1)
    return img[yi, xi], inb


def project(pts: torch.Tensor, cam: CameraArrays, K: torch.Tensor):
    """World points (M,3) -> (u, v, view z): pixel coordinates of the
    reference's half-pixel convention and the view-space depth."""
    ones = torch.ones_like(pts[:, :1])
    view = torch.cat([pts, ones], dim=-1) @ cam.world_view
    z = view[:, 2]
    pix = view[:, :3] @ K
    safe_z = torch.where(z != 0, z, 1.0)
    return pix[:, 0] / safe_z, pix[:, 1] / safe_z, z


def grid_axes(vol: TSDFVolume):
    """World coordinates of the volume's voxel centres along x, y and z."""
    dev = vol.tsdf.device
    return tuple(
        torch.from_numpy(vol.origin[i:i + 1]).to(dev)
        + vol.voxel * torch.arange(n, dtype=torch.float32, device=dev)
        for i, n in enumerate(vol.tsdf.shape))


@torch.no_grad()
def integrate(
    vol: TSDFVolume,
    cam: CameraArrays,
    depth: torch.Tensor,           # (H, W) view-z depth; 0 = no surface
    color: torch.Tensor,           # (H, W, 3)
    sdf_trunc: float,
    depth_trunc: float,
    width: int,
    height: int,
) -> TSDFVolume:
    """Fuse one view into the bounded volume, in place; returns `vol`."""
    nx, ny, nz = vol.tsdf.shape
    K = view_to_pix_matrix(cam, width, height)      # x_pix_h = x_view @ K
    xs, ys, zs = grid_axes(vol)
    depth = torch.where(depth > depth_trunc, 0.0, depth)

    for x0 in range(0, nx, SLAB_BLOCK):
        b = min(SLAB_BLOCK, nx - x0)
        shape = (b, ny, nz)
        pts = torch.stack([xs[x0:x0 + b, None, None].expand(shape),
                           ys[None, :, None].expand(shape),
                           zs[None, None, :].expand(shape)], dim=-1).reshape(-1, 3)
        u, v, z = project(pts, cam, K)
        del pts
        d, inb = _sample_nearest(depth, u, v)
        c, _ = _sample_nearest(color, u, v)
        sdf = d - z
        valid = inb & (z > 0) & (d > 0) & (sdf > -sdf_trunc)
        w_new = valid.to(torch.float32)
        t_new = (torch.clamp(sdf / sdf_trunc, -1.0, 1.0) * w_new).reshape(shape)
        c_new = (c * w_new[:, None]).reshape(*shape, 3)
        w_new = w_new.reshape(shape)
        del u, v, z, d, c, sdf, valid, inb

        t_old = vol.tsdf[x0:x0 + b]
        w_old = vol.weight[x0:x0 + b]
        c_old = vol.color[x0:x0 + b]
        w_tot = w_old + w_new
        safe = torch.clamp(w_tot, min=1e-12)
        seen = w_tot > 0
        t_acc = (t_old * w_old + t_new) / safe
        c_acc = (c_old * w_old[..., None] + c_new) / safe[..., None]
        t_old.copy_(torch.where(seen, t_acc, t_old))
        c_old.copy_(torch.where(seen[..., None], c_acc, c_old))
        w_old.copy_(w_tot)
    return vol


@torch.no_grad()
def extract_mesh(vol: TSDFVolume, min_weight: float = 1e-6):
    """Marching tetrahedra over the fused volume; returns (verts, faces,
    vertex_colors) as numpy arrays. The tsdf and the observed mask go to
    the host for marching; the colours are gathered on the device."""
    from tpu2dgs_torch.mesh.marching import marching_tetrahedra

    tsdf, mask = vol.tsdf.cpu().numpy(), (vol.weight > min_weight).cpu().numpy()
    verts, faces = marching_tetrahedra(
        tsdf, level=0.0,
        origin=vol.origin, spacing=(vol.voxel,) * 3,
        mask=mask,
    )
    del tsdf, mask
    colors = _sample_volume_colors(vol, verts)
    return verts, faces, colors


def _sample_volume_colors(vol: TSDFVolume, verts: np.ndarray) -> np.ndarray:
    if verts.shape[0] == 0:
        return np.zeros((0, 3))
    ijk = np.clip(
        np.round((verts - vol.origin[None, :]) / vol.voxel).astype(np.int64),
        0,
        np.array(vol.tsdf.shape) - 1,
    )
    idx = torch.from_numpy(ijk).to(vol.color.device)
    return vol.color[idx[:, 0], idx[:, 1], idx[:, 2]].cpu().numpy()


# -- unbounded (contracted space) -------------------------------------------


def contract(x: torch.Tensor) -> torch.Tensor:
    """Mip-NeRF-360 sphere contraction (reference mesh_utils.py:189-191)."""
    mag = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    safe = torch.clamp(mag, min=1e-12)
    return torch.where(mag > 1.0, (2.0 - torch.reciprocal(safe)) * (x / safe), x)


def uncontract(y: torch.Tensor) -> torch.Tensor:
    """Inverse contraction (reference mesh_utils.py:193-195)."""
    mag = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    safe = torch.clamp(mag, min=1e-12)
    return torch.where(mag > 1.0, torch.reciprocal(2.0 - safe) * (y / safe), y)


# The unbounded (contracted) fusion lives in mesh/extract.py
# (_fuse_world_slab): it is specialized to precomputed world-space slab
# points so the per-slab uncontract runs once, not once per view.
