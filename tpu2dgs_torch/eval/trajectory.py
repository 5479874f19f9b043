"""Camera-trajectory file IO + similarity registration for TnT evaluation
(the port's own copy of tpu2dgs/eval/trajectory.py: numpy, on the host).

Covers the reference eval_tnt toolbox behaviors the F-score protocol needs
(scripts/eval_tnt/trajectory_io.py, registration.py:44-108, run.py:110-161)
without open3d:

  * `.log` trajectory files (TanksAndTemples camera format): blocks of one
    metadata line + a 4x4 camera-to-world matrix,
  * `_trans.txt` 4x4 alignment matrices (GT-frame transform),
  * `_mapping.txt` sparse-frame mapping files,
  * correspondence RANSAC with scale (the reference's o3d
    registration_ransac_based_on_correspondence with
    TransformationEstimationPointToPoint(with_scaling=True)) seeded by the
    1:1 pairing of estimated and COLMAP-frame GT camera centers,
  * the Umeyama closed-form similarity estimator both RANSAC and the
    scaled ICP refinement stages build on.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class CameraPose(NamedTuple):
    metadata: tuple
    pose: np.ndarray  # (4,4) camera-to-world


def read_trajectory(path: str) -> list[CameraPose]:
    """TnT .log format (trajectory_io.py:23-35)."""
    traj = []
    with open(path) as f:
        meta = f.readline()
        while meta.strip():
            mat = np.stack([
                np.fromstring(f.readline(), dtype=np.float64, sep=" \t")
                for _ in range(4)
            ])
            traj.append(CameraPose(tuple(int(x) for x in meta.split()), mat))
            meta = f.readline()
    return traj


def write_trajectory(traj: list[CameraPose], path: str) -> None:
    with open(path, "w") as f:
        for cp in traj:
            f.write(" ".join(map(str, cp.metadata)) + "\n")
            for row in cp.pose:
                f.write(" ".join(f"{v:.12f}" for v in row) + "\n")


def read_mapping(path: str):
    """Sparse-frame mapping file (registration.py:44-56). Returns
    (n_sampled, n_total, (n_sampled, 2) int array)."""
    with open(path) as f:
        n_sampled = int(f.readline())
        n_total = int(f.readline())
        rows = [list(map(int, f.readline().split())) for _ in range(n_sampled)]
    return n_sampled, n_total, np.asarray(rows, dtype=np.int64)


def sparse_trajectory(mapping: np.ndarray,
                      traj: list[CameraPose]) -> list[CameraPose]:
    """Subsample a every-movie-frame trajectory to the mapped frames
    (registration.py:59-63; indices in the file are 1-based)."""
    return [traj[int(m[1]) - 1] for m in mapping]


def trajectory_centers(traj: list[CameraPose]) -> np.ndarray:
    return np.stack([cp.pose[:3, 3] for cp in traj])


def umeyama(src: np.ndarray, dst: np.ndarray,
            with_scale: bool = True) -> np.ndarray:
    """Closed-form least-squares similarity transform src -> dst (4x4).

    The estimator under the reference's TransformationEstimationPointToPoint
    (with_scaling=True): rotation from the SVD of the centered covariance,
    scale from the variance ratio, translation from the centroids."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    a = src - mu_s
    b = dst - mu_d
    cov = b.T @ a / src.shape[0]
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u @ vt))
    diag = np.diag([1.0, 1.0, d])
    rot = u @ diag @ vt
    if with_scale:
        var_s = (a ** 2).sum() / src.shape[0]
        scale = float(np.trace(np.diag(s) @ diag) / max(var_s, 1e-12))
    else:
        scale = 1.0
    t = mu_d - scale * rot @ mu_s
    out = np.eye(4)
    out[:3, :3] = scale * rot
    out[:3, 3] = t
    return out


def _umeyama_batch(src: np.ndarray, dst: np.ndarray,
                   with_scale: bool) -> np.ndarray:
    """Batched `umeyama`: (B, k, 3) point sets -> (B, 4, 4) similarities."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    k = src.shape[1]
    mu_s = src.mean(1)
    mu_d = dst.mean(1)
    a = src - mu_s[:, None]
    b = dst - mu_d[:, None]
    cov = np.einsum("bki,bkj->bij", b, a) / k
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u @ vt))
    diag = np.zeros_like(cov)
    diag[:, 0, 0] = 1.0
    diag[:, 1, 1] = 1.0
    diag[:, 2, 2] = d
    rot = u @ diag @ vt
    if with_scale:
        var_s = np.maximum((a ** 2).sum(axis=(1, 2)) / k, 1e-12)
        scale = (s[:, 0] + s[:, 1] + d * s[:, 2]) / var_s
    else:
        scale = np.ones(src.shape[0])
    out = np.broadcast_to(np.eye(4), (src.shape[0], 4, 4)).copy()
    out[:, :3, :3] = scale[:, None, None] * rot
    out[:, :3, 3] = mu_d - np.einsum(
        "b,bij,bj->bi", scale, rot, mu_s)
    return out


def ransac_correspondences(src: np.ndarray, dst: np.ndarray,
                           threshold: float, n_sample: int = 6,
                           max_iteration: int = 100_000,
                           with_scale: bool = True,
                           seed: int = 0) -> np.ndarray:
    """RANSAC over known 1:1 correspondences, scaled-Umeyama model.

    Mirrors registration.py:71-108: sample `n_sample` pairs, fit a
    similarity, count inliers within `threshold`, refit on the best inlier
    set. Recovers arbitrary scale + pose between the frames."""
    n = src.shape[0]
    if n < n_sample:
        return umeyama(src, dst, with_scale)
    rng = np.random.default_rng(seed)
    best_inliers: Optional[np.ndarray] = None
    best_count = -1
    # Honor the full trial budget (the reference's o3d criteria run 100K
    # trials, registration.py:96) with an adaptive early stop: once the
    # best inlier ratio makes a better all-inlier sample overwhelmingly
    # unlikely, further trials are wasted. Trials run in vectorized
    # batches (batched Umeyama + residual einsum) so low-inlier inputs
    # where the stop never tightens still finish in seconds, not minutes.
    need = float(max_iteration)
    batch = 1024
    done = 0
    while done < min(need, max_iteration):
        b = min(batch, max_iteration - done)
        done += b
        # (b, n_sample) distinct column indices per row.
        idx = np.argpartition(
            rng.random((b, n)), n_sample - 1, axis=1)[:, :n_sample]
        ts = _umeyama_batch(src[idx], dst[idx], with_scale)  # (b, 4, 4)
        res = (np.einsum("nj,bij->bni", src, ts[:, :3, :3])
               + ts[:, None, :3, 3] - dst[None])
        inl = np.einsum("bni,bni->bn", res, res) < threshold * threshold
        counts = inl.sum(axis=1)
        j = int(np.argmax(counts))
        c = int(counts[j])
        if c > best_count:
            best_count = c
            best_inliers = inl[j]
            if c == n:
                break
            # trials for 99.9% odds of one all-inlier sample at this ratio
            p_good = (c / n) ** n_sample
            if p_good > 1e-12:  # log1p stays accurate; else keep budget
                need = np.log(1e-3) / np.log1p(-min(p_good, 1.0 - 1e-12))
    if best_inliers is None or best_count < n_sample:
        return umeyama(src, dst, with_scale)
    return umeyama(src[best_inliers], dst[best_inliers], with_scale)


def align_trajectories(est_traj: list[CameraPose],
                       gt_colmap_traj: list[CameraPose],
                       gt_trans: Optional[np.ndarray] = None,
                       map_file: Optional[str] = None,
                       threshold: float = 0.2,
                       seed: int = 0) -> np.ndarray:
    """Reference trajectory_alignment (registration.py:65-108): align the
    estimated camera centers to the GT-frame COLMAP camera centers (after
    applying `gt_trans`) by scaled correspondence RANSAC. Returns the 4x4
    est->GT-frame similarity."""
    gt_centers = trajectory_centers(gt_colmap_traj)
    if gt_trans is not None:
        gt_centers = gt_centers @ gt_trans[:3, :3].T + gt_trans[:3, 3]
    if len(est_traj) > 1600 and map_file is not None:
        _, _, mapping = read_mapping(map_file)
        est_traj = sparse_trajectory(mapping, est_traj)
    est_centers = trajectory_centers(est_traj)
    m = min(len(est_centers), len(gt_centers))
    return ransac_correspondences(
        est_centers[:m], gt_centers[:m], threshold, seed=seed)


class CropVolume(NamedTuple):
    """Selection polygon volume (o3d crop json): an extruded 2D polygon
    along one axis (run.py's `read_selection_polygon_volume(cropfile)`)."""

    orthogonal_axis: int          # 0=X 1=Y 2=Z
    axis_min: float
    axis_max: float
    polygon: np.ndarray           # (P, 2) in the two in-plane axes


def read_crop_json(path: str) -> CropVolume:
    import json

    with open(path) as f:
        d = json.load(f)
    axis = {"x": 0, "y": 1, "z": 2}[d["orthogonal_axis"].lower()]
    poly = np.asarray(d["bounding_polygon"], np.float64)
    keep = [i for i in range(3) if i != axis]
    return CropVolume(
        orthogonal_axis=axis,
        axis_min=float(d["axis_min"]),
        axis_max=float(d["axis_max"]),
        polygon=poly[:, keep],
    )


def crop_points(pts: np.ndarray, vol: Optional[CropVolume]) -> np.ndarray:
    """Boolean mask of points inside the extruded polygon volume."""
    if vol is None:
        return np.ones(pts.shape[0], bool)
    axis = vol.orthogonal_axis
    keep_axes = [i for i in range(3) if i != axis]
    inside = (pts[:, axis] >= vol.axis_min) & (pts[:, axis] <= vol.axis_max)
    p2 = pts[:, keep_axes]
    poly = vol.polygon
    # even-odd ray casting, vectorized over points
    wn = np.zeros(pts.shape[0], bool)
    j = len(poly) - 1
    for i in range(len(poly)):
        xi, yi = poly[i]
        xj, yj = poly[j]
        crosses = ((yi > p2[:, 1]) != (yj > p2[:, 1])) & (
            p2[:, 0] < (xj - xi) * (p2[:, 1] - yi) / (yj - yi + 1e-30) + xi
        )
        wn ^= crosses
        j = i
    return inside & wn
