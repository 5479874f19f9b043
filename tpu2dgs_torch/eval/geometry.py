"""Geometry evaluation: Chamfer distance (DTU-style) and F-score (TnT-style)
(the port's own copy of tpu2dgs/eval/geometry.py: numpy and scipy, on the host).

Reference counterparts: scripts/eval_dtu/eval.py:98-158 (point-to-point
Chamfer with downsampling) and scripts/eval_tnt/evaluation.py:60
(EvaluateHisto precision/recall at threshold tau). scipy cKDTree replaces
sklearn/open3d neighbor queries; mesh surfaces are sampled uniformly by
triangle area (the reference's face-center + vertex augmentation,
eval_tnt/run.py:95-108, is a special case).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def sample_mesh_points(verts: np.ndarray, faces: np.ndarray, n: int,
                       seed: int = 0) -> np.ndarray:
    """Uniform area-weighted surface samples (plus vertices if n allows)."""
    if faces.shape[0] == 0:
        return verts[:n]
    tri = verts[faces]
    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1
    )
    p = area / max(area.sum(), 1e-12)
    rng = np.random.default_rng(seed)
    idx = rng.choice(faces.shape[0], size=n, p=p)
    u = rng.random((n, 1))
    v = rng.random((n, 1))
    flip = (u + v) > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    t = tri[idx]
    return t[:, 0] + u * (t[:, 1] - t[:, 0]) + v * (t[:, 2] - t[:, 0])


def downsample_points(pts: np.ndarray, density: float) -> np.ndarray:
    """Keep one point per `density`-sized voxel cell (reference
    eval_dtu/eval.py's reducePts-style thinning)."""
    if pts.shape[0] == 0:
        return pts
    keys = np.floor(pts / density).astype(np.int64)
    _, first = np.unique(keys, axis=0, return_index=True)
    return pts[np.sort(first)]


def chamfer_distance(data_pts: np.ndarray, gt_pts: np.ndarray,
                     max_dist: float | None = None):
    """Returns (mean d2s, mean s2d, overall). DTU convention: accuracy =
    data->gt distances, completeness = gt->data, distances clipped at
    max_dist if given (reference eval.py uses 20mm outlier threshold)."""
    t_gt = cKDTree(gt_pts)
    d2s, _ = t_gt.query(data_pts, k=1)
    t_d = cKDTree(data_pts)
    s2d, _ = t_d.query(gt_pts, k=1)
    if max_dist is not None:
        d2s = np.minimum(d2s, max_dist)
        s2d = np.minimum(s2d, max_dist)
    mean_d2s = float(d2s.mean())
    mean_s2d = float(s2d.mean())
    return mean_d2s, mean_s2d, 0.5 * (mean_d2s + mean_s2d)


def fscore(data_pts: np.ndarray, gt_pts: np.ndarray, tau: float):
    """Returns (precision, recall, f1) at threshold tau (reference
    eval_tnt/evaluation.py EvaluateHisto)."""
    t_gt = cKDTree(gt_pts)
    d2s, _ = t_gt.query(data_pts, k=1)
    precision = float(np.mean(d2s < tau))
    t_d = cKDTree(data_pts)
    s2d, _ = t_d.query(gt_pts, k=1)
    recall = float(np.mean(s2d < tau))
    f1 = (
        2.0 * precision * recall / (precision + recall)
        if precision + recall > 0 else 0.0
    )
    return precision, recall, f1


def align_icp(source: np.ndarray, target: np.ndarray, iters: int = 20,
              max_corr: float | None = None, with_scale: bool = False):
    """Point-to-point ICP returning a 4x4 transform (reference
    eval_tnt/run.py:156-161 refinement; the reference estimator is
    TransformationEstimationPointToPoint(with_scaling=True), enabled here
    via `with_scale`)."""
    from tpu2dgs_torch.eval.trajectory import umeyama

    T = np.eye(4)
    src = source.copy()
    tree = cKDTree(target)
    for _ in range(iters):
        dist, idx = tree.query(src, k=1)
        if max_corr is not None:
            keep = dist < max_corr
            if keep.sum() < 3:
                break
        else:
            keep = np.ones(len(src), bool)
        step = umeyama(src[keep], target[idx[keep]], with_scale=with_scale)
        T = step @ T
        src = src @ step[:3, :3].T + step[:3, 3]
    return T


def pr_curves(data_pts: np.ndarray, gt_pts: np.ndarray, tau: float,
              stretch: float = 5.0, bins: int = 100):
    """Cumulative precision/recall curves over distance thresholds.

    The histogram behind the reference's TnT PR plot artifact
    (the reference's scripts/eval_tnt/plot.py + evaluation.py histograms):
    cum_precision[i] = fraction of data points within edges[i+1] of GT,
    cum_recall[i] likewise for GT->data, with edges spanning
    [0, stretch * tau]. cum_*[at tau] reproduce fscore()'s terms.

    Returns (edges (bins+1,), cum_precision (bins,), cum_recall (bins,)).
    """
    t_gt = cKDTree(gt_pts)
    d2s, _ = t_gt.query(data_pts, k=1)
    t_d = cKDTree(data_pts)
    s2d, _ = t_d.query(gt_pts, k=1)
    edges = np.linspace(0.0, stretch * tau, bins + 1)
    cum_p = np.array([np.mean(d2s <= e) for e in edges[1:]])
    cum_r = np.array([np.mean(s2d <= e) for e in edges[1:]])
    return edges, cum_p, cum_r
