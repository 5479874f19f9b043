"""tpu2dgs_torch.mesh's post-processing and PLY codec against
tpu2dgs.mesh's, on a marched sphere with a floater (equal outputs and
byte-equal files), and eval.mesh_profile's mesh run on the CPU at a tiny
size. Fusion and culling are tests/test_torch_mesh.py's."""

import numpy as np
import pytest

from tests.test_mesh import _sphere_grid
from tests.test_torch_mesh import H, W
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.mesh import extract as jextract
from tpu2dgs.mesh import marching as jmarching
from tpu2dgs_torch.mesh import extract as textract


def _floater_mesh():
    field, ax = _sphere_grid(n=24)
    verts, faces = jmarching.marching_tetrahedra(field, origin=(-1, -1, -1),
                                                 spacing=(ax[1] - ax[0],) * 3)
    verts = np.concatenate([verts, [[5, 5, 5], [5.1, 5, 5], [5, 5.1, 5]]])
    faces = np.concatenate([faces, [[len(verts) - 3, len(verts) - 2, len(verts) - 1]]])
    colors = np.random.default_rng(2).random((len(verts), 3))
    return verts, faces, colors


@pytest.mark.parametrize("num_cluster", [1, 50])
def test_post_process_matches_jax(num_cluster):
    verts, faces, colors = _floater_mesh()
    got = textract.post_process_mesh(verts, faces, colors, num_cluster=num_cluster)
    want = jextract.post_process_mesh(verts, faces, colors, num_cluster=num_cluster)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[1].shape[0] == faces.shape[0] - 1  # the floater's face is dropped
    assert textract.post_process_mesh(verts, faces[:0], None)[1].shape == (0, 3)


@pytest.mark.parametrize("with_colors", [True, False])
def test_mesh_ply_both_ways(tmp_path, with_colors):
    verts, faces, colors = _floater_mesh()
    colors = colors if with_colors else None
    tpath, jpath = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    textract.write_mesh_ply(tpath, verts, faces, colors)
    jextract.write_mesh_ply(jpath, verts, faces, colors)
    with open(tpath, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    for read in (textract.read_mesh_ply, jextract.read_mesh_ply):
        for path in (tpath, jpath):
            rv, rf = read(path)
            np.testing.assert_array_equal(rv, verts.astype(np.float32).astype(np.float64))
            np.testing.assert_array_equal(rf, faces)


@pytest.mark.parametrize("unbounded", [False, True])
def test_mesh_profile_runs_on_cpu(unbounded):
    """eval.mesh_profile's mesh run at a tiny size: every stage timed, the
    kept maps counted, a mesh fused and post-processed."""
    from tpu2dgs_torch.eval import mesh_profile, synthetic

    _, scene = synthetic.make_shell_scene(W, H, 2048, seed=0, device="cpu")
    got = mesh_profile.mesh_run(scene, 2, 24, unbounded, w=W, h=H, device="cpu")
    s = got["seconds"]
    assert {"reconstruction", "extract", "fusion", "marching", "extract_rest",
            "post_process", "write_ply"} <= s.keys()
    assert s["fusion"] + s["marching"] <= s["extract"] <= got["total_seconds"]
    assert s["fusion_per_view"] == s["fusion"] / 2
    assert got["map_bytes"] == 2 * 5 * W * H * 4  # rgb, depth and alpha of each view
    assert 0 < got["post"]["faces"] <= got["fused"]["faces"]
