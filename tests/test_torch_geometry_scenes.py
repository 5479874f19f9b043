"""tpu2dgs_torch.eval's trajectory files and its TnT and DTU scene
evaluators against tpu2dgs.eval and scripts/, on the CPU, at the shapes of
tests/test_tnt.py: equal outputs (the same numpy arithmetic in the same
order), and an end-to-end TnT run that recovers F1 > 0.99 on a scene in a
scaled, rotated and translated COLMAP frame, as tests/test_tnt.py demands.
The geometry functions are tests/test_torch_geometry.py's."""

import json
import os

import numpy as np

import scripts.eval_dtu_scene as jdtu
import scripts.eval_tnt_scene as jtnt
from tests.test_tnt import _rot, _similarity
from tests.test_torch_geometry import _equal, _sphere_mesh
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.eval import trajectory as jtio
from tpu2dgs_torch.data.scene import store_ply
from tpu2dgs_torch.eval import dtu_scene as tdtu
from tpu2dgs_torch.eval import tnt_scene as ttnt
from tpu2dgs_torch.eval import trajectory as ttio
from tpu2dgs_torch.mesh.extract import write_mesh_ply


def test_trajectory_files_both_ways(tmp_path):
    rng = np.random.default_rng(2)
    traj = []
    for i in range(5):
        m = np.eye(4)
        m[:3, :3] = _rot(rng.normal(size=3), rng.uniform(0, 3))
        m[:3, 3] = rng.normal(size=3)
        traj.append(ttio.CameraPose((i, i, 0), m))
    tpath, jpath = str(tmp_path / "port.log"), str(tmp_path / "jax.log")
    ttio.write_trajectory(traj, tpath)
    jtio.write_trajectory([jtio.CameraPose(*cp) for cp in traj], jpath)
    with open(tpath) as a, open(jpath) as b:
        assert a.read() == b.read()
    for got, want in ((ttio.read_trajectory(jpath), traj), (jtio.read_trajectory(tpath), traj)):
        assert [cp.metadata for cp in got] == [cp.metadata for cp in want]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.pose, b.pose, atol=1e-10)

    (tmp_path / "map.txt").write_text("3\n5\n1 1\n2 3\n3 5\n")
    n, total, mapping = ttio.read_mapping(str(tmp_path / "map.txt"))
    _equal((n, total, mapping), jtio.read_mapping(str(tmp_path / "map.txt")))
    assert [cp.metadata[0] for cp in ttio.sparse_trajectory(mapping, traj)] == [0, 2, 4]
    _equal(ttio.trajectory_centers(traj), jtio.trajectory_centers(traj))

    crop = {"orthogonal_axis": "Z", "axis_min": -1.0, "axis_max": 1.0,
            "bounding_polygon": [[0, 0, 0], [2, 0, 0], [2, 2, 0], [0, 2, 0]]}
    (tmp_path / "crop.json").write_text(json.dumps(crop))
    vol = ttio.read_crop_json(str(tmp_path / "crop.json"))
    pts = rng.uniform(-1, 3, (500, 3))
    _equal(ttio.crop_points(pts, vol),
           jtio.crop_points(pts, jtio.read_crop_json(str(tmp_path / "crop.json"))))
    assert 0 < ttio.crop_points(pts, vol).sum() < 500


# -- the scene evaluators ----------------------------------------------------------


def _tnt_scene(tmp_path):
    """tests/test_tnt.py::test_tnt_scene_end_to_end's scene: a box shell in
    the GT frame, the reconstruction and a camera ring in a COLMAP frame
    related to it by scale 0.31, a rotation and a translation. Written with
    the port's writers; returns the flags both scripts take."""
    rng = np.random.default_rng(4)
    n = 4000
    face = rng.integers(0, 6, n)
    uv = rng.uniform(-1, 1, (n, 2))
    pts = np.zeros((n, 3))
    axis = face % 3
    sign = np.where(face < 3, 1.0, -1.0)
    for i in range(n):
        others = [j for j in range(3) if j != axis[i]]
        pts[i, axis[i]] = sign[i]
        pts[i, others[0]], pts[i, others[1]] = uv[i]
    gt_pts = pts * 2.0 + np.array([10.0, 5.0, 2.0])
    S_inv = np.linalg.inv(_similarity(0.31, [1, 1, 0], 2.0, [3.0, -1.0, 7.0]))
    est_pts = gt_pts @ S_inv[:3, :3].T + S_inv[:3, 3]
    ang = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    centers_gt = np.stack([10 + 6 * np.cos(ang), 5 + 6 * np.sin(ang), 2 + 0 * ang], 1)
    centers_est = centers_gt @ S_inv[:3, :3].T + S_inv[:3, 3]

    def traj_of(centers):
        out = []
        for i, c in enumerate(centers):
            m = np.eye(4)
            m[:3, 3] = c
            out.append(ttio.CameraPose((i, i, 0), m))
        return out

    paths = {k: str(tmp_path / v) for k, v in (
        ("gt_log", "gt_COLMAP_SfM.log"), ("est_log", "est.log"), ("trans", "gt_trans.txt"),
        ("gt_ply", "gt.ply"), ("mesh", "mesh.ply"))}
    ttio.write_trajectory(traj_of(centers_gt), paths["gt_log"])
    ttio.write_trajectory(traj_of(centers_est), paths["est_log"])
    np.savetxt(paths["trans"], np.eye(4))
    store_ply(paths["gt_ply"], gt_pts, np.full((n, 3), 0.5))
    write_mesh_ply(paths["mesh"], est_pts, np.zeros((0, 3), np.int64))
    return ["--gt-ply", paths["gt_ply"], "--ply-path", paths["mesh"], "--tau", "0.1",
            "--traj-path", paths["est_log"], "--gt-log", paths["gt_log"],
            "--gt-trans", paths["trans"], "--n-samples", "4000"]


def test_tnt_scene_matches_script(tmp_path):
    flags = _tnt_scene(tmp_path)
    tout, jout = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    plots = tmp_path / "plots"
    ttnt.main([*flags, "--out", tout, "--plot", str(plots), "--scene-name", "synthetic"])
    jtnt.main([*flags, "--out", jout, "--plot", str(tmp_path / "jplots"),
               "--scene-name", "synthetic"])
    with open(tout) as a, open(jout) as b:
        got, want = json.load(a), json.load(b)
    assert got == want
    assert got["f1"] > 0.99, got
    for ext in ("png", "pdf"):
        assert (plots / f"PR_synthetic_@d_th_0_1000.{ext}").exists()


def _dtu_scan(tmp_path, scan_id=1):
    """A DTU layout around the r = 0.7 sphere mesh: official points on the
    sphere, an ObsMask volume observing its upper half, a ground plane below
    its lowest tenth, and two views whose masks hold a small disk to the
    right of its centre: dilated, they cover part of the sphere."""
    from PIL import Image
    import scipy.io as sio

    verts, faces = _sphere_mesh(n=32)
    mesh = str(tmp_path / "mesh.ply")
    write_mesh_ply(mesh, verts, faces)
    dtu = tmp_path / "DTU"
    (dtu / "Points" / "stl").mkdir(parents=True)
    (dtu / "ObsMask").mkdir()
    rng = np.random.default_rng(5)
    d = rng.normal(size=(20000, 3))
    stl = 0.7 * d / np.linalg.norm(d, axis=1, keepdims=True)
    store_ply(str(dtu / "Points" / "stl" / f"stl{scan_id:03d}_total.ply"), stl,
              np.full((len(stl), 3), 0.5))
    res = 0.05
    bb = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]])
    obs = np.zeros((40, 40, 40), np.uint8)
    obs[:, 20:, :] = 1
    sio.savemat(str(dtu / "ObsMask" / f"ObsMask{scan_id}_10.mat"),
                {"ObsMask": obs, "BB": bb, "Res": np.array([[res]])})
    sio.savemat(str(dtu / "ObsMask" / f"Plane{scan_id}.mat"),
                {"P": np.array([[0.0], [1.0], [0.0], [0.56]])})

    scan = tmp_path / "masks" / f"scan{scan_id}"
    (scan / "mask").mkdir(parents=True)
    w = h = 64
    mats = {}
    for i, ang in enumerate((0.0, 1.3)):
        R = _rot([0, 1, 0], ang)
        t = np.array([0.0, 0.0, 3.0])
        K = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]])
        P = np.eye(4)
        P[:3, :4] = K @ np.concatenate([R, t[:, None]], axis=1)
        mats[f"world_mat_{i}"] = P
        yy, xx = np.mgrid[:h, :w]
        disk = ((xx - w / 2 - 20) ** 2 + (yy - h / 2) ** 2 < 3 ** 2).astype(np.uint8) * 255
        Image.fromarray(disk).save(scan / "mask" / f"{i:03d}.png")
    np.savez(scan / "cameras.npz", **mats)
    return ["--input_mesh", mesh, "--scan_id", str(scan_id), "--DTU", str(dtu),
            "--mask_dir", str(tmp_path / "masks")]


def test_dtu_scene_matches_script(tmp_path):
    flags = _dtu_scan(tmp_path)
    tdtu.main([*flags, "--output_dir", str(tmp_path / "port")])
    jdtu.main([*flags, "--output_dir", str(tmp_path / "jax")])
    with open(tmp_path / "port" / "results.json") as a, \
            open(tmp_path / "jax" / "results.json") as b:
        got, want = json.load(a), json.load(b)
    assert got == want
    assert all(np.isfinite(v) for v in got.values())
    # the masks keep a cap of the sphere: accuracy on it is near 0, while the
    # official points elsewhere are far from the culled mesh
    assert got["mean_d2s"] < 0.05 < got["mean_s2d"], got

    verts, faces = _sphere_mesh(n=32)
    scan_dir = os.path.join(str(tmp_path / "masks"), "scan1")
    _equal(tdtu.cull_by_masks(verts, faces, scan_dir), jdtu.cull_by_masks(verts, faces, scan_dir))
    assert 0 < len(tdtu.cull_by_masks(verts, faces, scan_dir)[1]) < len(faces)
