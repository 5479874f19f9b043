"""tpu2dgs_torch.mesh's fusion and culling against tpu2dgs.mesh, on the CPU,
at the shapes of tests/test_mesh.py (marching and contraction are
tests/test_torch_mesh_marching.py's, post-processing and the PLY codec
tests/test_torch_mesh_post.py's).

Both packages get the same numpy inputs: analytic depth maps of a sphere
seen from orbit cameras (each package builds its own Camera from the same
R, T and field of view) and colour maps from a seeded generator. Both
extractors are fed one `render_fn` returning those maps, so the JAX side
compiles fusion only and no render. The grids each extractor hands to
marching are caught on the way and compared.

Tolerances:
  * marching tetrahedra, post-processing, the PLY codec, culling: equal
    (the same numpy code, or boolean decisions on the same projections);
  * contract / uncontract: allclose at 1e-6;
  * fused volumes: allclose at rtol = atol = 1e-5 (the unbounded path's
    float16 grid: that plus one float16 step, since two float32 values
    within 1e-5 may round to neighbouring float16 values). The one
    exception is a voxel whose projected u or v lies within 1e-3 px of a
    half-integer in either package: a last-ulp difference in the projection
    may round it to the other pixel. The voxels excused so are counted and
    held to at most 0.1% of the observed voxels;
  * meshes: face counts within 0.5%, symmetric Chamfer between the two
    meshes' vertices at most 0.01 voxel; where no voxel was excused, the
    same faces, and vertices within 1e-3 voxel: an edge's crossing
    t = -a / (b - a) moves by the grids' last-ulp difference over b - a,
    which is small where the fused field is flat.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_mesh import _sphere_grid
from tests.test_train import _orbit_camera
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.core import cameras as jcam
from tpu2dgs.mesh import cull as jcull
from tpu2dgs.mesh import extract as jextract
from tpu2dgs.mesh import marching as jmarching
from tpu2dgs.mesh import tsdf as jtsdf
from tpu2dgs_torch.core import cameras as tcam
from tpu2dgs_torch.eval.geometry import chamfer_distance
from tpu2dgs_torch.mesh import cull as tcull
from tpu2dgs_torch.mesh import extract as textract
from tpu2dgs_torch.mesh import marching as tmarching
from tpu2dgs_torch.mesh import tsdf as ttsdf

W = H = 64
BOUNDARY_PX = 1e-3       # |frac(u or v) - 0.5| below this: a rounding tie
BOUNDARY_SHARE = 1e-3    # flagged voxels allowed, as a share of observed ones
VOL_TOL = 1e-5
FACE_COUNT_REL = 5e-3
CHAMFER_VOXELS = 0.01


def _port_camera(cam, alpha_mask=None):
    return tcam.Camera(uid=cam.uid, image_name=cam.image_name, R=cam.R, T=cam.T,
                       fovx=cam.fovx, fovy=cam.fovy, width=cam.width, height=cam.height,
                       alpha_mask=alpha_mask)


def _sphere_views(r, n_views=3, cam_dist=2.5):
    """Orbit views of a sphere of radius r at the origin: JAX cameras, port
    cameras, depth (H,W) and colour (3,H,W) maps (tests/test_mesh.py's
    analytic depth). View 1 carries an alpha mask over part of the sphere."""
    jcams, depths = [], []
    for i, ang in enumerate(np.linspace(0, 2 * np.pi, n_views, endpoint=False)):
        cam = _orbit_camera(i, ang, radius=cam_dist, w=W, h=H)
        xs = (np.arange(W) - (W - 1) / 2) / (W / 2) * np.tan(cam.fovx / 2)
        ys = (np.arange(H) - (H - 1) / 2) / (H / 2) * np.tan(cam.fovy / 2)
        gx, gy = np.meshgrid(xs, ys)
        c2w = np.linalg.inv(np.asarray(cam.world_view))
        dirs = np.stack([gx, gy, np.ones_like(gx)], -1) @ c2w[:3, :3]
        origin = c2w[3, :3]
        # |o + t d|^2 = r^2, t in view-z units (dirs have unit view z)
        a = (dirs ** 2).sum(-1)
        b = 2 * (dirs * origin).sum(-1)
        disc = b * b - 4 * a * ((origin ** 2).sum() - r * r)
        t = (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a)
        depths.append(np.where((disc > 0) & (t > 0), t, 0.0).astype(np.float32))
        jcams.append(cam)
    rng = np.random.default_rng(0)
    colors = [rng.random((3, H, W)).astype(np.float32) for _ in jcams]
    mask = np.ones((1, H, W), np.float32)
    mask[:, 24:40, 20:44] = 0.0
    jcams[1].alpha_mask = mask
    tcams = [_port_camera(c, c.alpha_mask) for c in jcams]
    return jcams, tcams, depths, colors, r


@pytest.fixture(scope="module")
def views():
    """The r = 0.5 sphere of tests/test_mesh.py."""
    return _sphere_views(0.5)


@pytest.fixture(scope="module")
def big_views():
    """A sphere of radius 1.2 seen from 2.5: 0.48 of the cameras' radius,
    so it spans 6-9 voxels of the 32-48 contracted grid of the unbounded
    path, where the r = 0.5 sphere spans 2-3."""
    return _sphere_views(1.2)


def _maps(depths, colors):
    """One render_fn for both extractors: the precomputed maps by camera uid."""
    def render_fn(cam):
        d = depths[cam.uid]
        return {"render": colors[cam.uid], "surf_depth": d[None],
                "rend_alpha": (d > 0).astype(np.float32)[None]}
    return render_fn


def _near_half(a):
    return np.abs(a - np.floor(a) - 0.5) < BOUNDARY_PX


def _boundary(pts_port, pts_jax, tcams, jcams):
    """(M,) bool: the world point projects within BOUNDARY_PX of a pixel
    boundary, in front of some view and near its image, in either package
    (the port's projection and the JAX package's arithmetic, eagerly)."""
    flag = np.zeros(len(pts_port), bool)
    for tc, jc in zip(tcams, jcams):
        ta = tc.arrays("cpu")
        u, v, z = (a.numpy() for a in ttsdf.project(
            torch.from_numpy(np.asarray(pts_port, np.float32)), ta,
            tcam.view_to_pix_matrix(ta, W, H)))
        ja = jc.arrays()
        pj = jnp.asarray(pts_jax, jnp.float32)
        view = jnp.concatenate([pj, jnp.ones_like(pj[:, :1])], axis=-1) @ ja.world_view
        jz = view[:, 2]
        pix = view[:, :3] @ jcam.view_to_pix_matrix(ja, W, H)
        safe = jnp.where(jz != 0, jz, 1.0)
        projections = ((u, v, z), tuple(np.asarray(a) for a in
                                        (pix[:, 0] / safe, pix[:, 1] / safe, jz)))
        for uu, vv, zz in projections:
            near_image = (zz > 0) & (uu > -1) & (uu < W) & (vv > -1) & (vv < H)
            flag |= near_image & (_near_half(uu) | _near_half(vv))
    return flag


def _excused(got, want, flag, observed, tol=VOL_TOL):
    """Voxels where the port's grid is not within tolerance of the JAX
    package's: each must be a boundary voxel (flag), and there may be at
    most BOUNDARY_SHARE of the observed ones. Returns how many there are."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    off = np.abs(got - want) > tol + VOL_TOL * np.abs(want)
    off = off.reshape(*flag.shape, -1).any(axis=-1)
    assert not (off & ~flag).any(), (
        f"{int((off & ~flag).sum())} voxels differ off a pixel boundary, "
        f"max |d| {np.abs(got - want).max()}")
    assert off.sum() <= BOUNDARY_SHARE * observed.sum(), (off.sum(), observed.sum())
    return int(off.sum())


def _assert_meshes_match(port, ref, voxel, excused):
    (tv, tf, tc), (jv, jf, jc) = port, ref
    assert jf.shape[0] > 200
    assert abs(tf.shape[0] - jf.shape[0]) <= FACE_COUNT_REL * jf.shape[0]
    acc, comp, _ = chamfer_distance(tv, jv)
    assert max(acc, comp) <= CHAMFER_VOXELS * voxel, (acc, comp, voxel)
    if excused == 0:
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-3 * voxel)
        np.testing.assert_allclose(tc, jc, rtol=VOL_TOL, atol=VOL_TOL)


class Marching:
    """Records the (grid, mask) each call of a package's
    marching_tetrahedra receives."""

    def __init__(self, monkeypatch, module):
        self.calls = []
        orig = module.marching_tetrahedra

        def spy(grid, *args, **kwargs):
            self.calls.append((np.array(grid), kwargs.get("mask")))
            return orig(grid, *args, **kwargs)

        monkeypatch.setattr(module, "marching_tetrahedra", spy)


# -- bounded fusion -------------------------------------------------------------


def test_integrate_matches_jax(views):
    """One volume fused from three views by tsdf.integrate in each package
    (the port in place, block by block), then extract_mesh."""
    jcams, tcams, depths, colors, _ = views
    origin, dims, voxel = (-0.75, -0.75, -0.75), (50, 50, 50), 0.03
    assert dims[0] % ttsdf.SLAB_BLOCK != 0
    kw = dict(sdf_trunc=0.09, depth_trunc=5.0, width=W, height=H)
    jvol = jtsdf.make_volume(origin, dims, voxel)
    fuse = jax.jit(lambda vol, cam, d, c: jtsdf.integrate(vol, cam, d, c, **kw))
    tvol = ttsdf.make_volume(origin, dims, voxel, device="cpu")
    for jc, tc, d, c in zip(jcams, tcams, depths, colors):
        jvol = fuse(jvol, jc.arrays(), jnp.asarray(d), jnp.asarray(c.transpose(1, 2, 0)))
        # 50 slabs in blocks of 16: the last block is short
        out = ttsdf.integrate(tvol, tc.arrays("cpu"), torch.from_numpy(d),
                              torch.from_numpy(c.transpose(1, 2, 0)), **kw)
        assert out is tvol

    pts = np.stack(np.meshgrid(*(a.numpy() for a in ttsdf.grid_axes(tvol)),
                               indexing="ij"), -1).reshape(-1, 3)
    ax = [origin[i] + voxel * np.arange(n, dtype=np.float32) for i, n in enumerate(dims)]
    jpts = np.stack(np.meshgrid(*ax, indexing="ij"), -1).reshape(-1, 3)
    flag = _boundary(pts, jpts, tcams, jcams).reshape(dims)
    observed = np.asarray(jvol.weight) > 0
    assert observed.sum() > 5000
    excused = max(_excused(getattr(tvol, name).numpy(), getattr(jvol, name), flag, observed)
                  for name in ("tsdf", "weight", "color"))

    port = ttsdf.extract_mesh(tvol)
    ref = jtsdf.extract_mesh(jvol)
    assert port[2].dtype == ref[2].dtype
    _assert_meshes_match(port, ref, voxel, excused)


def test_extractor_bounded_matches_jax(views, monkeypatch):
    """GaussianExtractor end to end: reconstruction, bounding sphere, the
    masked depth of view 1, bounded fusion and marching."""
    jcams, tcams, depths, colors, _ = views
    jex = jextract.GaussianExtractor(_maps(depths, colors))
    tex = textract.GaussianExtractor(_maps(depths, colors), device="cpu")
    jex.reconstruction(jcams)
    tex.reconstruction(tcams)
    assert all(isinstance(m, torch.Tensor) for m in tex.depthmaps)
    np.testing.assert_array_equal(tex.center, jex.center)
    assert tex.radius == jex.radius
    for i in range(len(jcams)):
        np.testing.assert_array_equal(tex._masked_depth(i, True).numpy(),
                                      jex._masked_depth(i, True))
    assert (tex._masked_depth(1, True) == 0).sum() > (tex._masked_depth(1, False) == 0).sum()

    kw = dict(voxel_size=0.04, sdf_trunc=0.12, depth_trunc=2.0 * jex.radius)
    tm, jm = Marching(monkeypatch, tmarching), Marching(monkeypatch, jmarching)
    port = tex.extract_mesh_bounded(**kw)
    ref = jex.extract_mesh_bounded(**kw)
    (tgrid, tmask), = tm.calls
    (jgrid, jmask), = jm.calls
    n = int(np.ceil(kw["depth_trunc"] / kw["voxel_size"])) + 1
    assert tgrid.shape == jgrid.shape == (n, n, n)
    # both grids start at the same float32 corner and step alike
    vol = ttsdf.make_volume(tex.center - kw["depth_trunc"] / 2.0, (n, n, n),
                            kw["voxel_size"], device="cpu")
    pts = np.stack(np.meshgrid(*(a.numpy() for a in ttsdf.grid_axes(vol)),
                               indexing="ij"), -1).reshape(-1, 3)
    flag = _boundary(pts, pts, tcams, jcams).reshape(n, n, n)
    excused = max(_excused(tgrid, jgrid, flag, jmask), _excused(tmask, jmask, flag, jmask))
    _assert_meshes_match(port, ref, kw["voxel_size"], excused)


# -- unbounded fusion -------------------------------------------------------------


@pytest.mark.parametrize("res", [32, 48])
def test_extract_mesh_unbounded_matches_jax(big_views, res, monkeypatch):
    jcams, tcams, depths, colors, _ = big_views
    jex = jextract.GaussianExtractor(_maps(depths, colors))
    tex = textract.GaussianExtractor(_maps(depths, colors), device="cpu")
    jex.reconstruction(jcams)
    tex.reconstruction(tcams)
    tm, jm = Marching(monkeypatch, tmarching), Marching(monkeypatch, jmarching)
    port = tex.extract_mesh_unbounded(resolution=res, slab_batch=12)
    ref = jex.extract_mesh_unbounded(resolution=res)
    (tgrid, tmask), = tm.calls
    (jgrid, jmask), = jm.calls
    assert tgrid.dtype == jgrid.dtype == np.float16 and tmask.dtype == bool

    # every voxel of the contracted grid, in world space in each package
    r = 1.8
    step = 2 * r / (res - 1)
    ax = -r + np.arange(res, dtype=np.float32) * np.float32(step)
    grid = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    tworld = ttsdf.uncontract(torch.from_numpy(grid)).numpy() * tex.radius + \
        tex.center.astype(np.float32)
    jworld = np.asarray(jtsdf.uncontract(jnp.asarray(grid))) * jex.radius + \
        jex.center.astype(np.float32)
    flag = _boundary(tworld, jworld, tcams, jcams).reshape(res, res, res)
    f16_step = np.spacing(np.abs(jgrid)).astype(np.float64)
    excused = max(_excused(tgrid, jgrid, flag, jmask, tol=VOL_TOL + f16_step),
                  _excused(tmask, jmask, flag, jmask))
    # the world size of a voxel at the sphere (inside the unit ball)
    _assert_meshes_match(port, ref, step * tex.radius, excused)


# -- culling ---------------------------------------------------------------------


def test_cull_mesh_matches_jax(views):
    """The keep mask of the sphere's own mesh against the three views'
    depths (hidden and off-frame vertices culled), and the hand-made case of
    tests/test_mesh.py."""
    jcams, tcams, depths, _, r = views
    field, ax = _sphere_grid(n=40, r=r)
    verts, faces = jmarching.marching_tetrahedra(field, origin=(-1, -1, -1),
                                                 spacing=(ax[1] - ax[0],) * 3)
    dmaps = [d[None] for d in depths]
    for min_views in (1, 2):
        tv, tf, tk = tcull.cull_mesh(verts, faces, tcams, [torch.from_numpy(d) for d in dmaps],
                                     eps=0.02, min_views=min_views)
        jv, jf, jk = jcull.cull_mesh(verts, faces, jcams, dmaps, eps=0.02, min_views=min_views)
        np.testing.assert_array_equal(tk, _remaining(jk, faces))
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tv, verts[tk])
        assert 0 < tk.sum() < len(verts)

    cam = dict(uid=0, image_name="c", R=np.eye(3), T=np.zeros(3),
               fovx=np.pi / 2, fovy=np.pi / 2, width=W, height=H)
    depth = np.full((1, H, W), 2.0, np.float32)
    pts = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.99], [0.0, 0.0, 3.0],
                    [10.0, 0.0, 1.0], [0.0, 0.0, -1.0]], np.float32)
    tri = np.array([[0, 1, 2], [0, 1, 1], [2, 3, 4]])
    got = tcull.cull_mesh(pts, tri, [tcam.Camera(**cam)], [depth], eps=0.05)
    want = jcull.cull_mesh(pts, tri, [jcam.Camera(**cam)], [depth], eps=0.05)
    np.testing.assert_array_equal(got[2], [True, True, False, False, False])
    np.testing.assert_array_equal(got[2], _remaining(want[2], tri))
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)


def _remaining(seen, faces):
    """The vertices left in a face whose three vertices were all seen: what
    the port's cull_mesh returns, from the JAX package's seen mask."""
    kept = np.zeros(len(seen), bool)
    kept[faces[seen[faces].all(axis=1)].reshape(-1)] = True
    return kept


def test_cli_culled_mesh_colours_follow_vertices(big_views, tmp_path, monkeypatch):
    """cli.render's mesh branch, unbounded with --cull_views 1: every vertex
    of fuse_unbounded_post.ply carries the colour that the same vertex has
    in fuse_unbounded.ply, on a mesh where some vertices seen by a view are
    left in no kept face."""
    from tpu2dgs_torch.cli import render as cli_render

    _, tcams, depths, colors, _ = big_views
    written = {}

    def capture(path, verts, faces, cols=None):
        written[path.rsplit("/", 1)[-1]] = (verts, faces, cols)

    monkeypatch.setattr(textract, "write_mesh_ply", capture)
    args = cli_render.build_parser().parse_args(
        ["-m", str(tmp_path), "--unbounded", "--mesh_res", "48", "--cull_views", "1"])
    cli_render.extract_mesh(args, tcams, _maps(depths, colors), str(tmp_path), "cpu")
    fv, ff, fc = written["fuse_unbounded.ply"]
    pv, pf, pc = written["fuse_unbounded_post.ply"]
    assert len(pc) == len(pv) and len(pf) > 0

    ex = textract.GaussianExtractor(_maps(depths, colors), device="cpu")
    ex.reconstruction(tcams)
    seen = sum(tcull._seen_in_view(torch.from_numpy(fv.astype(np.float32)), c.arrays("cpu"),
                                   ex.depthmaps[i][0], args.cull_eps, W, H).numpy()
               for i, c in enumerate(tcams)) >= 1
    kept = _remaining(seen, ff)
    assert (seen & ~kept).any()  # the case where the two masks differ

    index = {tuple(v): i for i, v in enumerate(fv)}
    at = np.array([index[tuple(v)] for v in pv])
    np.testing.assert_array_equal(pc, fc[at])
