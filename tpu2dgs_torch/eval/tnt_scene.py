"""Tanks&Temples single-scene F-score — the full official protocol (port of
scripts/eval_tnt_scene.py, same flags):

    python3 -m tpu2dgs_torch.eval.tnt_scene --gt-ply <scene>.ply \
        --ply-path <model>/train/ours_<it>/fuse_post.ply --tau <scene tau> \
        [--traj-path <est .log or cameras.json> --gt-log <scene>_COLMAP_SfM.log \
         --gt-trans <scene>_trans.txt --crop-json <scene>.json] [--plot DIR]

Numpy and scipy on the host: nothing of it runs on the GPU.

Mirrors reference scripts/eval_tnt/run.py:58-200 without open3d:
  1. estimated camera trajectory (.log / cameras.json) is aligned to the
     GT-frame COLMAP trajectory (<scene>_COLMAP_SfM.log transformed by
     <scene>_trans.txt) with scaled correspondence RANSAC — this recovers
     the arbitrary scale + pose of the COLMAP frame,
  2. mesh points (vertices + face-center-augmented samples, run.py:95-108)
     are mapped to the GT frame and cropped to the official selection
     polygon volume (<scene>.json),
  3. 3-stage scaled-ICP refinement on voxel/uniform-downsampled clouds
     (registration.py:133-177: dTau*80 @ voxel dTau, dTau*20 @ voxel
     dTau/2, 2*dTau uniform),
  4. precision/recall/F1 histogram at the per-scene tau
     (evaluation.py EvaluateHisto; both clouds downsampled at dTau/2).

Without --gt-log/--gt-trans (e.g. synthetic data already in the GT frame)
step 1 is skipped and ICP alone refines, as round 1 did.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def load_estimated_trajectory(path):
    """Estimated camera poses: TnT .log or a model-dir cameras.json."""
    from tpu2dgs_torch.eval import trajectory as tio

    if path.endswith(".json"):
        with open(path) as f:
            cams = json.load(f)
        traj = []
        for c in cams:
            mat = np.eye(4)
            mat[:3, :3] = np.asarray(c["rotation"])
            mat[:3, 3] = np.asarray(c["position"])
            traj.append(tio.CameraPose((c["id"],), mat))
        return traj
    return tio.read_trajectory(path)


def main(argv=None):
    from tpu2dgs_torch.eval import trajectory as tio
    from tpu2dgs_torch.eval.geometry import (
        align_icp, downsample_points, fscore, pr_curves,
        sample_mesh_points,
    )
    from tpu2dgs_torch.mesh.extract import read_mesh_ply
    from tpu2dgs_torch.model.splats import read_ply_vertices

    parser = argparse.ArgumentParser()
    parser.add_argument("--gt-ply", required=True)
    parser.add_argument("--ply-path", required=True)
    parser.add_argument("--tau", type=float, required=True)
    parser.add_argument("--traj-path", default=None,
                        help="estimated trajectory (.log or cameras.json)")
    parser.add_argument("--gt-log", default=None,
                        help="<scene>_COLMAP_SfM.log GT-frame trajectory")
    parser.add_argument("--gt-trans", default=None,
                        help="<scene>_trans.txt 4x4 alignment")
    parser.add_argument("--crop-json", default=None,
                        help="<scene>.json selection polygon volume")
    parser.add_argument("--map-file", default=None)
    parser.add_argument("--out", default="f1.json")
    parser.add_argument("--n-samples", type=int, default=2_000_000)
    parser.add_argument("--plot", default=None, metavar="DIR",
                        help="write the PR_<scene> precision/recall curve "
                             "plot + histogram (reference plot.py artifact)")
    parser.add_argument("--scene-name", default="scene")
    args = parser.parse_args(argv)

    verts, faces = read_mesh_ply(args.ply_path)
    data_pts = sample_mesh_points(verts, faces, n=args.n_samples)
    gt_v = read_ply_vertices(args.gt_ply)
    gt_pts = np.stack([gt_v["x"], gt_v["y"], gt_v["z"]], 1).astype(np.float64)

    # 1. trajectory-based similarity registration (scale + pose).
    if args.traj_path and args.gt_log:
        est_traj = load_estimated_trajectory(args.traj_path)
        gt_traj = tio.read_trajectory(args.gt_log)
        gt_trans = np.loadtxt(args.gt_trans) if args.gt_trans else None
        T0 = tio.align_trajectories(est_traj, gt_traj, gt_trans,
                                    map_file=args.map_file)
        data_pts = data_pts @ T0[:3, :3].T + T0[:3, 3]
        scale = float(np.cbrt(np.linalg.det(T0[:3, :3])))
        print(f"trajectory RANSAC: scale {scale:.4f}")

    # 2. crop to the official evaluation volume.
    vol = tio.read_crop_json(args.crop_json) if args.crop_json else None
    if vol is not None:
        data_pts = data_pts[tio.crop_points(data_pts, vol)]
        gt_pts = gt_pts[tio.crop_points(gt_pts, vol)]

    # 3. scaled-ICP refinement in 3 stages (registration.py cadence).
    tau = args.tau
    stages = ((tau, tau * 80), (tau / 2.0, tau * 20), (None, 2 * tau))
    pts = data_pts
    for voxel, max_corr in stages:
        src = downsample_points(pts, voxel) if voxel else pts
        tgt = downsample_points(gt_pts, voxel) if voxel else gt_pts
        step = align_icp(src, tgt, iters=20, max_corr=max_corr,
                         with_scale=True)
        pts = pts @ step[:3, :3].T + step[:3, 3]

    # 4. F-score at tau on dTau/2-downsampled clouds (EvaluateHisto).
    d_down = downsample_points(pts, tau / 2.0)
    g_down = downsample_points(gt_pts, tau / 2.0)
    precision, recall, f1 = fscore(d_down, g_down, tau)
    print(f"precision {precision:.4f}  recall {recall:.4f}  f1 {f1:.4f} "
          f"(tau {tau})")
    result = {"precision": precision, "recall": recall, "f1": f1,
              "tau": tau}
    if args.plot:
        edges, cum_p, cum_r = pr_curves(d_down, g_down, tau)
        result["pr_curves"] = {"edges": edges.tolist(),
                               "cum_precision": cum_p.tolist(),
                               "cum_recall": cum_r.tolist()}
        save_pr_plot(args.plot, args.scene_name, f1, tau, edges, cum_p,
                     cum_r)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)


def save_pr_plot(out_dir, scene, f1, tau, edges, cum_p, cum_r):
    """The reference's TnT website-toolbox PR artifact: cumulative
    precision/recall vs distance, F-score in the title, dashed line at
    tau (plot.py:40-109 behavior; clean-room matplotlib)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(10, 5))
    ax.plot(edges[1:], cum_p * 100, c="red", lw=2.0, label="precision")
    ax.plot(edges[1:], cum_r * 100, c="blue", lw=2.0, label="recall")
    ax.axvline(x=tau, c="black", ls="dashed", lw=2.0)
    ax.grid(True)
    ax.set_xlim(0, edges[-1])
    ax.set_ylim(0, 100)
    ax.set_xlabel("Meters")
    ax.set_ylabel("# of points (%)")
    ax.set_title(f"Precision and Recall: {scene}, {f1 * 100:05.2f} f-score")
    ax.legend(loc="lower right")
    name = os.path.join(
        out_dir, f"PR_{scene}_@d_th_0_{int(tau * 10000):04d}")
    fig.savefig(name + ".png", bbox_inches="tight")
    fig.savefig(name + ".pdf", format="pdf", bbox_inches="tight")
    plt.close(fig)


if __name__ == "__main__":
    main()
