"""DTU single-scan geometry evaluation: mask culling + Chamfer distance (port
of scripts/eval_dtu_scene.py, same flags):

    python3 -m tpu2dgs_torch.eval.dtu_scene --input_mesh <model>/train/ours_<it>/fuse_post.ply \
        --scan_id <ID> --DTU <official DTU dir> [--mask_dir <dtu scans>] [--output_dir DIR]

Numpy, scipy and PIL on the host: nothing of it runs on the GPU.

Re-implements reference scripts/eval_dtu/evaluate_single_scene.py (cull the
fused mesh by the scan's dilated object masks) and scripts/eval_dtu/eval.py
(point-to-surface Chamfer against the official structured-light points, with
the ObsMask observability volume and ground-plane filtering), replacing
open3d/sklearn with scipy + the port's geometry module.

Expects the standard DTU layout:
  <mask_dir>/scan<ID>/mask/*.png          object masks per view
  <mask_dir>/scan<ID>/cameras.npz | cams  projection matrices (optional)
  <DTU>/Points/stl/stl<ID:03d>_total.ply  official points
  <DTU>/ObsMask/ObsMask<ID>_10.mat        observability volume (BB, Res)
  <DTU>/ObsMask/Plane<ID>.mat             ground plane
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def load_obs_mask(path):
    import scipy.io as sio

    data = sio.loadmat(path)
    return data["ObsMask"], data["BB"], float(np.asarray(data["Res"]).squeeze())


def load_plane(path):
    import scipy.io as sio

    return sio.loadmat(path)["P"]


def cull_by_masks(verts, faces, scan_dir):
    """Drop mesh faces whose vertices project outside every view's dilated
    object mask (reference evaluate_single_scene.py:19-101)."""
    import scipy.ndimage as ndi
    from PIL import Image

    cam_file = os.path.join(scan_dir, "cameras.npz")
    mask_dir = os.path.join(scan_dir, "mask")
    if not (os.path.exists(cam_file) and os.path.isdir(mask_dir)):
        return verts, faces  # nothing to cull with
    cams = np.load(cam_file)
    names = sorted(os.listdir(mask_dir))
    keep = np.zeros(verts.shape[0], bool)
    homog = np.concatenate([verts, np.ones((verts.shape[0], 1))], axis=1)
    for i, name in enumerate(names):
        key = f"world_mat_{i}"
        if key not in cams:
            continue
        P = cams[key][:3]
        with Image.open(os.path.join(mask_dir, name)) as im:
            mask = np.asarray(im.convert("L")) > 127
        mask = ndi.binary_dilation(mask, iterations=12)
        pix = homog @ P.T
        z = pix[:, 2]
        u = np.round(pix[:, 0] / np.maximum(z, 1e-9)).astype(int)
        v = np.round(pix[:, 1] / np.maximum(z, 1e-9)).astype(int)
        inb = (z > 0) & (u >= 0) & (u < mask.shape[1]) & (v >= 0) & (v < mask.shape[0])
        ok = np.zeros_like(keep)
        ok[inb] = mask[v[inb], u[inb]]
        keep |= ok
    face_keep = keep[faces].all(axis=1)
    return verts, faces[face_keep]


def dtu_eval(data_pts, stl_pts, obs_mask, bb, res, plane,
             max_dist=20.0, patch=60.0):
    """Chamfer with observability + plane filtering (reference eval.py:98-158)."""
    from scipy.spatial import cKDTree

    # data -> stl (accuracy): only data points inside the ObsMask volume
    idx = np.floor((data_pts - bb[0:1]) / res).astype(int)
    shape = np.array(obs_mask.shape)
    inb = np.all((idx >= 0) & (idx < shape[None, :]), axis=1)
    observed = np.zeros(data_pts.shape[0], bool)
    observed[inb] = obs_mask[idx[inb, 0], idx[inb, 1], idx[inb, 2]] > 0
    d2s_pts = data_pts[observed]
    dist_d2s = cKDTree(stl_pts).query(d2s_pts, k=1)[0] if len(d2s_pts) else np.array([np.inf])
    dist_d2s = np.minimum(dist_d2s, max_dist)

    # stl -> data (completeness): only stl points above the ground plane
    above = (np.concatenate([stl_pts, np.ones((stl_pts.shape[0], 1))], 1)
             @ plane.reshape(4, 1))[:, 0] > 0
    s2d_pts = stl_pts[above]
    dist_s2d = cKDTree(data_pts).query(s2d_pts, k=1)[0] if len(data_pts) else np.array([np.inf])
    dist_s2d = np.minimum(dist_s2d, max_dist)

    return float(dist_d2s.mean()), float(dist_s2d.mean())


def main(argv=None):
    from tpu2dgs_torch.eval.geometry import downsample_points, sample_mesh_points
    from tpu2dgs_torch.mesh.extract import read_mesh_ply
    from tpu2dgs_torch.model.splats import read_ply_vertices

    parser = argparse.ArgumentParser()
    parser.add_argument("--input_mesh", required=True)
    parser.add_argument("--scan_id", required=True, type=int)
    parser.add_argument("--output_dir", default="tmp")
    parser.add_argument("--mask_dir", default="")
    parser.add_argument("--DTU", required=True)
    parser.add_argument("--downsample_density", type=float, default=0.2)
    args = parser.parse_args(argv)

    verts, faces = read_mesh_ply(args.input_mesh)
    if args.mask_dir:
        verts, faces = cull_by_masks(
            verts, faces, os.path.join(args.mask_dir, f"scan{args.scan_id}"))

    data_pts = sample_mesh_points(verts, faces, n=2_000_000)
    data_pts = downsample_points(data_pts, args.downsample_density)

    stl_file = os.path.join(
        args.DTU, "Points", "stl", f"stl{args.scan_id:03d}_total.ply")
    v = read_ply_vertices(stl_file)
    stl_pts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)

    obs_mask, bb, res = load_obs_mask(
        os.path.join(args.DTU, "ObsMask", f"ObsMask{args.scan_id}_10.mat"))
    plane = load_plane(os.path.join(args.DTU, "ObsMask", f"Plane{args.scan_id}.mat"))

    mean_d2s, mean_s2d = dtu_eval(data_pts, stl_pts, obs_mask, bb, res, plane)
    over_all = (mean_d2s + mean_s2d) / 2.0
    print(f"scan{args.scan_id}  d2s {mean_d2s:.3f}  s2d {mean_s2d:.3f}  "
          f"chamfer {over_all:.3f}")

    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "results.json"), "w") as f:
        json.dump({"mean_d2s": mean_d2s, "mean_s2d": mean_s2d,
                   "overall": over_all}, f, indent=2)


if __name__ == "__main__":
    main()
