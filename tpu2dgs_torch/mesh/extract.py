"""Mesh extraction pipeline — the `GaussianExtractor` equivalent (port of
tpu2dgs/mesh/extract.py).

Mirrors reference utils/mesh_utils.py:73-295: render all training views
(rgb + surf_depth + alpha), estimate the scene bounding sphere from camera
poses, fuse a TSDF (bounded regular grid or contracted/unbounded grid),
run iso-surface extraction, color vertices, and drop floater clusters.

The rendered maps stay on the extractor's device (default CUDA) until
fusion reads them there; only marching (numpy), the camera poses
(float64) and the narrowed unbounded blocks go to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from tpu2dgs_torch import default_device
from tpu2dgs_torch.core.cameras import Camera, view_to_pix_matrix
from tpu2dgs_torch.mesh import tsdf as tsdf_lib


@dataclasses.dataclass
class GaussianExtractor:
    """render_fn(camera) -> render-pkg dict (the api.render contract); its
    maps may be tensors or numpy arrays and are kept on `device`."""

    render_fn: Callable[[Camera], dict]
    device: Any = None

    def __post_init__(self):
        self.device = default_device(self.device)
        self.rgbmaps: list[torch.Tensor] = []
        self.depthmaps: list[torch.Tensor] = []
        self.alphamaps: list[torch.Tensor] = []
        self.cameras: list[Camera] = []
        self.radius: float = 1.0
        self.center: np.ndarray = np.zeros(3)

    def _on_device(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def reconstruction(self, cameras: list[Camera]):
        """Render every view and keep rgb/depth/alpha on the device
        (reference mesh_utils.py:100-123)."""
        self.cameras = list(cameras)
        self.rgbmaps, self.depthmaps, self.alphamaps = [], [], []
        for cam in self.cameras:
            out = self.render_fn(cam)
            self.rgbmaps.append(self._on_device(out["render"]))       # (3,H,W)
            self.depthmaps.append(self._on_device(out["surf_depth"])) # (1,H,W)
            self.alphamaps.append(self._on_device(out["rend_alpha"])) # (1,H,W)
        self.estimate_bounding_sphere()

    def estimate_bounding_sphere(self):
        """Focus point + min camera distance (reference mesh_utils.py:125-137)."""
        c2ws = np.stack([np.linalg.inv(np.asarray(c.world_view).T)
                         for c in self.cameras])
        poses = c2ws @ np.diag([1.0, -1.0, -1.0, 1.0])
        centers = c2ws[:, :3, 3]
        self.center = focus_point_fn(poses)
        self.radius = float(np.linalg.norm(centers - self.center[None], axis=-1).min())

    def _masked_depth(self, i: int, mask_background: bool) -> torch.Tensor:
        depth = self.depthmaps[i][0].clone()
        cam = self.cameras[i]
        if mask_background and cam.alpha_mask is not None:
            # reference mesh_utils.py:167-168: gt alpha < 0.5 -> no surface
            m = cam.alpha_mask[0]
            if m.shape == tuple(depth.shape):
                depth[self._on_device(m) < 0.5] = 0.0
        return depth

    @torch.no_grad()
    def extract_mesh_bounded(self, voxel_size: float = 0.004,
                             sdf_trunc: float = 0.02, depth_trunc: float = 3.0,
                             mask_background: bool = True):
        """Bounded TSDF fusion on a regular grid
        (reference mesh_utils.py:140-181, defaults from render.py:98-100)."""
        lo = self.center - depth_trunc / 2.0
        dims = tuple(
            int(np.ceil(depth_trunc / voxel_size)) + 1 for _ in range(3)
        )
        vol = tsdf_lib.make_volume(lo, dims, voxel_size, device=self.device)
        cam0 = self.cameras[0]
        w, h = cam0.width, cam0.height
        for i, cam in enumerate(self.cameras):
            depth = self._masked_depth(i, mask_background)
            color = self.rgbmaps[i].permute(1, 2, 0)
            tsdf_lib.integrate(vol, cam.arrays(self.device), depth, color,
                               sdf_trunc, depth_trunc, w, h)
        return tsdf_lib.extract_mesh(vol)

    @torch.no_grad()
    def extract_mesh_unbounded(self, resolution: int = 1024,
                               sdf_trunc: Optional[float] = None,
                               slab_batch: int = 16):
        """Contracted-space TSDF + marching tetrahedra
        (reference mesh_utils.py:184-279). The grid spans the contracted
        cube [-R, R]^3 with R slightly under 2; world = center +
        radius * uncontract(y). Fused block by block of `slab_batch`
        x-slabs; each block is narrowed on the device for the copy to the
        host: f16 tsdf (marching's interpolation noise floor), bool
        observed mask, u8 running-mean colour, 5x less than three f32
        grids."""
        from tpu2dgs_torch.mesh.marching import marching_tetrahedra

        res = int(resolution)
        r = 1.8
        if sdf_trunc is None:
            sdf_trunc = 8.0 * r / res  # ~2 voxels, matching ref's voxel-tied trunc
        dev = self.device
        cam0 = self.cameras[0]
        w, h = cam0.width, cam0.height

        # normalize world so cameras sit inside the unit sphere:
        # y = contract((x - center) / radius)
        views = [(cam.arrays(dev), self._masked_depth(i, True),
                  self.rgbmaps[i].permute(1, 2, 0))
                 for i, cam in enumerate(self.cameras)]
        radius = float(self.radius)
        center = torch.as_tensor(self.center, dtype=torch.float32, device=dev)
        trunc = float(sdf_trunc)
        step_sz = (2.0 * r) / (res - 1)
        ys = -r + torch.arange(res, dtype=torch.float32, device=dev) * step_sz

        full_tsdf = np.empty((res, res, res), np.float16)
        full_mask = np.empty((res, res, res), bool)
        full_color = np.empty((res, res, res, 3), np.uint8)
        for x0 in range(0, res, slab_batch):
            b = min(slab_batch, res - x0)
            shape = (b, res, res)
            # The contracted grid is made on the device from x0: uploading
            # point blocks would move more bytes than the fusion reads.
            xs = -r + (x0 + torch.arange(b, dtype=torch.float32, device=dev)) * step_sz
            flat_c = torch.stack([xs[:, None, None].expand(shape),
                                  ys[None, :, None].expand(shape),
                                  ys[None, None, :].expand(shape)], dim=-1).reshape(-1, 3)
            world = tsdf_lib.uncontract(flat_c) * radius + center[None, :]
            t = torch.zeros(shape, dtype=torch.float32, device=dev)
            wgt = torch.zeros(shape, dtype=torch.float32, device=dev)
            c = torch.zeros((*shape, 3), dtype=torch.float32, device=dev)
            for cam, depth, rgb in views:
                t, wgt, c = _fuse_world_slab(t, wgt, c, world, flat_c, cam, depth, rgb,
                                             sdf_trunc=trunc, w=w, h=h, radius=radius)
            full_tsdf[x0:x0 + b] = t.to(torch.float16).cpu().numpy()
            full_mask[x0:x0 + b] = (wgt > 1e-6).cpu().numpy()
            full_color[x0:x0 + b] = torch.clamp(c * 255.0, 0, 255).to(torch.uint8).cpu().numpy()

        verts_c, faces = marching_tetrahedra(
            full_tsdf, level=0.0, origin=(-r, -r, -r),
            spacing=(step_sz,) * 3,
            mask=full_mask,
        )
        # colors sampled in contracted grid space
        ijk = np.clip(
            np.round((verts_c - (-r)) / step_sz).astype(np.int64),
            0, res - 1,
        )
        colors = full_color[ijk[:, 0], ijk[:, 1], ijk[:, 2]] / 255.0
        verts = (
            tsdf_lib.uncontract(torch.from_numpy(verts_c.astype(np.float32))).numpy()
            * self.radius + self.center[None, :]
        )
        return verts, faces, colors


def _fuse_world_slab(tsdf, weight, color_acc, world_pts, contracted_pts,
                     cam, depth, color, sdf_trunc, w, h, radius):
    """integrate_contracted specialized to precomputed world points (slab)."""
    shape = tsdf.shape
    K = view_to_pix_matrix(cam, w, h)
    u, v, z = tsdf_lib.project(world_pts, cam, K)
    d, inb = tsdf_lib._sample_nearest(depth, u, v)
    c, _ = tsdf_lib._sample_nearest(color, u, v)

    mag = torch.sqrt(torch.sum(contracted_pts * contracted_pts, dim=-1))
    # a true division, as the JAX package's (a Python number over a tensor
    # would multiply by the tensor's reciprocal)
    num = torch.full_like(mag, sdf_trunc * radius)
    trunc = num / torch.clamp(2.0 - torch.clamp(mag, max=1.97), min=0.03)
    sdf = (d - z) / trunc
    valid = inb & (z > 0) & (d > 0) & (sdf > -1.0)
    t = torch.clamp(sdf, -1.0, 1.0)
    wgt = valid.to(torch.float32).reshape(shape)

    w_tot = weight + wgt
    safe = torch.clamp(w_tot, min=1e-12)
    new_tsdf = (tsdf * weight + t.reshape(shape) * wgt) / safe
    new_color = (
        color_acc * weight[..., None] + c.reshape(*shape, 3) * wgt[..., None]
    ) / safe[..., None]
    return (
        torch.where(w_tot > 0, new_tsdf, tsdf),
        w_tot,
        torch.where(w_tot[..., None] > 0, new_color, color_acc),
    )


def focus_point_fn(poses: np.ndarray) -> np.ndarray:
    """Point nearest to all camera optical axes (reference
    render_utils.py:62-71 / mesh_utils.py usage)."""
    directions, origins = poses[:, :3, 2:3], poses[:, :3, 3:4]
    m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
    mt_m = np.transpose(m, [0, 2, 1]) @ m
    focus_pt = np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]
    return focus_pt


def post_process_mesh(verts: np.ndarray, faces: np.ndarray,
                      colors: Optional[np.ndarray] = None,
                      num_cluster: int = 50, min_faces: int = 50):
    """Keep the largest connected clusters (reference mesh_utils.py:22-43:
    cluster_connected_triangles, keep top `num_cluster` with >= min_faces)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    if faces.shape[0] == 0:
        return verts, faces, colors
    n = verts.shape[0]
    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    adj = sp.coo_matrix((np.ones_like(rows), (rows, cols)), shape=(n, n))
    _, labels = connected_components(adj, directed=False)
    face_labels = labels[faces[:, 0]]
    sizes = np.bincount(face_labels, minlength=labels.max() + 1)
    keep_labels = np.argsort(sizes)[::-1][:num_cluster]
    keep_labels = keep_labels[sizes[keep_labels] >= min_faces]
    keep = np.isin(face_labels, keep_labels)
    faces = faces[keep]

    used = np.unique(faces)
    remap = -np.ones(n, np.int64)
    remap[used] = np.arange(used.shape[0])
    return (
        verts[used],
        remap[faces],
        None if colors is None else colors[used],
    )


def write_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray,
                   colors: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY with optional uchar vertex colors."""
    n, f = verts.shape[0], faces.shape[0]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [f"element face {f}", "property list uchar int vertex_indices",
               "end_header"]
    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        if colors is not None:
            vdt = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
            arr = np.empty(n, vdt)
            arr["xyz"] = verts.astype(np.float32)
            arr["rgb"] = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
        else:
            vdt = np.dtype([("xyz", "<f4", 3)])
            arr = np.empty(n, vdt)
            arr["xyz"] = verts.astype(np.float32)
        fh.write(arr.tobytes())
        fdt = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
        farr = np.empty(f, fdt)
        farr["n"] = 3
        farr["idx"] = faces.astype(np.int32)
        fh.write(farr.tobytes())


def read_mesh_ply(path: str):
    """Read back a mesh PLY written by write_mesh_ply (verts, faces)."""
    from tpu2dgs_torch.model.splats import _PLY_DTYPES

    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        nv = nf = 0
        vprops = []
        elem = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated PLY header")
            tok = line.decode().strip().split()
            if not tok:
                continue
            if tok[0] == "element":
                elem = tok[1]
                if elem == "vertex":
                    nv = int(tok[2])
                else:
                    nf = int(tok[2])
            elif tok[0] == "property" and elem == "vertex" and len(tok) == 3:
                vprops.append((tok[2], tok[1]))
            elif tok[0] == "end_header":
                break
        vdt = np.dtype([(nm, _PLY_DTYPES[t]) for nm, t in vprops])
        vraw = np.frombuffer(f.read(vdt.itemsize * nv), vdt)
        verts = np.stack([vraw["x"], vraw["y"], vraw["z"]], axis=1)
        fdt = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
        fraw = np.frombuffer(f.read(fdt.itemsize * nf), fdt)
        return verts.astype(np.float64), fraw["idx"].astype(np.int64)
