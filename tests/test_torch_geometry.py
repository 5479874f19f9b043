"""tpu2dgs_torch.eval geometry evaluators against tpu2dgs.eval and
scripts/, on the CPU, at the shapes of tests/test_tnt.py.

The port keeps its own copies of the numpy/scipy geometry and trajectory
modules and of the TnT and DTU scene scripts. Each function gets the same
inputs (and equal generators, by seed) in both packages and must give equal
outputs: the same numpy arithmetic in the same order, so no tolerance.
The trajectory files and the TnT and DTU scene evaluators are
tests/test_torch_geometry_scenes.py's.
"""


import numpy as np
import pytest

from tests.test_tnt import _similarity
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.eval import geometry as jgeo
from tpu2dgs.eval import trajectory as jtio
from tpu2dgs_torch.eval import geometry as tgeo
from tpu2dgs_torch.eval import trajectory as ttio
from tpu2dgs_torch.mesh.marching import marching_tetrahedra


def _sphere_mesh(n=24, r=0.7):
    ax = np.linspace(-1, 1, n)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return marching_tetrahedra(np.sqrt(x**2 + y**2 + z**2) - r, origin=(-1, -1, -1),
                               spacing=(ax[1] - ax[0],) * 3)


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


# -- geometry ---------------------------------------------------------------------


@pytest.mark.parametrize("faces", ["mesh", "vertices_only"])
def test_sample_and_downsample_match_jax(faces):
    verts, tri = _sphere_mesh()
    if faces == "vertices_only":
        tri = tri[:0]
    for seed in (0, 3):
        got = tgeo.sample_mesh_points(verts, tri, n=5000, seed=seed)
        _equal(got, jgeo.sample_mesh_points(verts, tri, n=5000, seed=seed))
        _equal(tgeo.downsample_points(got, 0.05), jgeo.downsample_points(got, 0.05))
    assert got.shape == ((5000, 3) if faces == "mesh" else (min(5000, len(verts)), 3))
    _equal(tgeo.downsample_points(got[:0], 0.05), got[:0])


def test_chamfer_fscore_pr_curves_match_jax():
    rng = np.random.default_rng(0)
    gt = rng.uniform(0, 1, (2000, 3))
    data = gt + rng.normal(0, 0.01, gt.shape)
    for max_dist in (None, 0.015):
        _equal(tgeo.chamfer_distance(data, gt, max_dist), jgeo.chamfer_distance(data, gt, max_dist))
    tau = 0.02
    p, r, f1 = tgeo.fscore(data, gt, tau)
    _equal((p, r, f1), jgeo.fscore(data, gt, tau))
    assert 0.5 < f1 < 1.0
    edges, cum_p, cum_r = tgeo.pr_curves(data, gt, tau, stretch=5.0, bins=100)
    _equal((edges, cum_p, cum_r), jgeo.pr_curves(data, gt, tau, stretch=5.0, bins=100))
    i = np.searchsorted(edges[1:], tau)
    assert abs(cum_p[i] - p) < 0.02 and abs(cum_r[i] - r) < 0.02


@pytest.mark.parametrize("with_scale,max_corr", [(True, None), (False, 0.2)])
def test_align_icp_matches_jax(with_scale, max_corr):
    rng = np.random.default_rng(3)
    target = rng.uniform(-1, 1, (2000, 3))
    T = _similarity(1.15 if with_scale else 1.0, [1, 0, 0], 0.05, [0.02, -0.01, 0.03])
    src = (target - T[:3, 3]) @ np.linalg.inv(T[:3, :3]).T
    est = tgeo.align_icp(src, target, iters=30, max_corr=max_corr, with_scale=with_scale)
    _equal(est, jgeo.align_icp(src, target, iters=30, max_corr=max_corr,
                               with_scale=with_scale))
    np.testing.assert_allclose(est, T, atol=0.01)


# -- trajectory ---------------------------------------------------------------------


def test_umeyama_and_ransac_match_jax():
    rng = np.random.default_rng(1)
    src = rng.normal(size=(80, 3))
    T = _similarity(2.5, [0, 0, 1], -0.7, [1.0, 2.0, 3.0])
    dst = src @ T[:3, :3].T + T[:3, 3]
    for with_scale in (True, False):
        _equal(ttio.umeyama(src, dst, with_scale), jtio.umeyama(src, dst, with_scale))
    bad = rng.choice(80, 20, replace=False)
    dst[bad] += rng.normal(scale=5.0, size=(20, 3))
    est = ttio.ransac_correspondences(src, dst, threshold=0.05, seed=2)
    _equal(est, jtio.ransac_correspondences(src, dst, threshold=0.05, seed=2))
    np.testing.assert_allclose(est, T, atol=1e-6)
    # fewer pairs than a sample: a plain fit
    _equal(ttio.ransac_correspondences(src[:4], dst[:4], 0.05),
           jtio.ransac_correspondences(src[:4], dst[:4], 0.05))
