"""Visibility culling of fused meshes against rendered depth maps (port of
tpu2dgs/mesh/cull.py).

The equivalent of the reference's optional TnT mesh culling
(scripts/eval_tnt/cull_mesh.py: pyrender mesh depth per training view ->
keep vertices observed in-frustum and in front of the depth within eps, in
>= min_views views; faces keep only if all three vertices survive). Two
deliberate differences, as in the JAX package:

  * The observation depths are the TRAINED MODEL's rendered surf_depth
    maps (already kept by GaussianExtractor.reconstruction) instead of
    re-rasterizing the mesh with a GL renderer — the fused mesh is built
    from exactly these maps, so "in front of the rendered depth" is the
    same visibility predicate without a pyrender/EGL dependency.
  * Projection + depth sampling run as one batched call per view over all
    vertices, on the depth maps' device.

The reference's own mainline disables this step (eval_tnt/run.py:245);
it ships here for parity and for post-hoc mesh cleanup (--cull_views in
cli/render).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu2dgs_torch.core.cameras import view_to_pix_matrix
from tpu2dgs_torch.mesh import tsdf as tsdf_lib


def _seen_in_view(verts, cam, depth, eps: float, w: int, h: int):
    """(N,) bool: vertex projects in-frustum and is not occluded by more
    than eps (reference point_masks semantics: where the depth map has no
    surface, frustum membership alone counts)."""
    K = view_to_pix_matrix(cam, w, h)
    u, v, z = tsdf_lib.project(verts, cam, K)
    in_frustum = (z > 0) & (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    d, inb = tsdf_lib._sample_nearest(depth, u, v)
    front = torch.where(d > 0.0, z < d + eps, True)
    return in_frustum & inb & front


@torch.no_grad()
def cull_mesh(verts: np.ndarray, faces: np.ndarray, cameras,
              depthmaps, eps: float = 0.01, min_views: int = 1):
    """Drop faces not observed by the training views.

    verts (V,3), faces (F,3); cameras: list of core.cameras.Camera;
    depthmaps: list of (1,H,W) rendered surf_depth maps (the
    GaussianExtractor's, tensors or arrays) on the device the culling runs
    on. Returns (verts', faces', kept) with unreferenced vertices removed:
    verts' = verts[kept], so per-vertex attributes follow as attr[kept]. A
    vertex seen in enough views but left in no kept face is not kept (the
    JAX package returns the seen mask instead, which runs ahead of verts'
    wherever that happens). min_views follows the reference's valid_num
    threshold (they use 20 with hundreds of T&T views; 1-3 suits sparse
    captures)."""
    depths = [torch.as_tensor(d, dtype=torch.float32) for d in depthmaps]
    dev = depths[0].device if depths else torch.device("cpu")
    vt = torch.as_tensor(np.asarray(verts, np.float32), device=dev)
    count = torch.zeros(len(verts), dtype=torch.int64, device=dev)
    for cam, depth in zip(cameras, depths):
        count += _seen_in_view(vt, cam.arrays(dev), depth[0], eps,
                               cam.width, cam.height)
    keep = (count >= min_views).cpu().numpy()
    face_mask = keep[faces].all(axis=1)
    faces_kept = faces[face_mask]
    used = np.zeros(len(verts), bool)
    used[faces_kept.reshape(-1)] = True
    remap = np.cumsum(used) - 1
    return verts[used], remap[faces_kept], used
