"""tpu2dgs_torch's command-line pipeline against tpu2dgs, on the CPU (the
kernels' plain versions), all on one cli.train run (the `trained` fixture):

  * cli.train on a COLMAP dataset written by the JAX package's writers, a
    resume from its checkpoint, cli.render's bounded and unbounded meshes
    (the bounded one held against the JAX package's extractor fed the
    port's diffuse maps), cli.render --skip_mesh, cli.metrics --no_lpips,
    and the model directory read back by the JAX package;
  * cli.render of a model directory whose cfg_args the JAX package's
    cli.train wrote, and of one that names the tiled backend; cli.train
    --backend tiled, its tile capacity healed after an overflow.

The configuration is tests/test_torch_cli_config.py's, and checkpoints,
the ground-truth budget and the Morton KNN tests/test_torch_cli_state.py's.
The JAX side here is numpy readers and writers, eager array code and one
TSDF fusion: no render or train step is compiled.
"""

import argparse
import json
import os
import shutil

import numpy as np
import pytest
import torch

from tests.test_data import _make_colmap_dataset
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.cli import config as jcfg
from tpu2dgs.model import splats as jsplats
from tpu2dgs.train import checkpoint as jckpt
from tpu2dgs_torch.cli import config as tcfg
from tpu2dgs_torch.cli import metrics as tcli_metrics
from tpu2dgs_torch.cli import render as tcli_render
from tpu2dgs_torch.cli import train as tcli_train
from tpu2dgs_torch.eval import synthetic
from tpu2dgs_torch.model import splats as tsplats
from tpu2dgs_torch.train import loop as tloop


# -- the pipeline ---------------------------------------------------------------


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


TRAIN_FLAGS = ["--eval", "--iterations", "6", "--save_iterations", "6",
               "--test_iterations", "6", "--densify_from_iter", "1000", "--resolution", "1",
               "--bin_capacity", "256", "--tile_capacity", "256", "--quiet",
               "--disable_viewer", "--max_capacity", "131072"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """cli.train for 6 iterations with a checkpoint at 3, on the CPU."""
    tmp = tmp_path_factory.mktemp("cli")
    root, out = str(tmp / "scene"), str(tmp / "out")
    os.makedirs(root)
    _make_colmap_dataset(root, n_views=6, n_pts=40)  # 64x48, the JAX package's writers
    trainer = tcli_train.main(["-s", root, "-m", out, "--checkpoint_iterations", "3",
                               *TRAIN_FLAGS], device="cpu")
    return root, out, trainer


def _finite_json(obj) -> bool:
    if isinstance(obj, dict):
        return all(_finite_json(v) for v in obj.values())
    if isinstance(obj, list):
        return all(_finite_json(v) for v in obj)
    return obj is None or isinstance(obj, str) or np.isfinite(obj)


def test_train_writes_the_model_directory(trained):
    root, out, trainer = trained
    assert trainer.step == 6 and trainer.adam.count == 6
    for name in ("cfg_args", "cameras.json", "input.ply", "metrics.jsonl", "chkpnt3.npz",
                 "point_cloud/iteration_6/point_cloud.ply"):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "cameras.json")) as f:
        cams = json.load(f)
    assert len(cams) == 6 and _finite_json(cams)
    assert {"id", "img_name", "width", "height", "position", "rotation", "fx", "fy"} \
        <= set(cams[0])
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert lines and all(_finite_json(line) for line in lines)
    keys = set().union(*lines)
    assert {"test/loss_viewpoint - psnr", "train/loss_viewpoint - l1_loss",
            "scene/opacity_histogram/mean", "total_points"} <= keys
    assert jcfg.load_cfg_args(out).source_path == root  # the JAX package reads it

    # the model directory in the JAX package: same points, same live count
    ply = os.path.join(out, "point_cloud", "iteration_6", "point_cloud.ply")
    jm = jsplats.load_ply(ply)
    assert int(jm.num_live()) == int(trainer.model.num_live()) == 40
    live = trainer.model.live.numpy()
    np.testing.assert_array_equal(np.asarray(jm.params.xyz)[:40],
                                  trainer.model.xyz.detach().numpy()[live])
    vv = jsplats.read_ply_vertices(os.path.join(out, "input.ply"))
    assert {"x", "y", "z", "nx", "red"} <= set(vv) and vv["x"].shape == (40,)
    jm3, ja3, step3, _ = jckpt.load_checkpoint(os.path.join(out, "chkpnt3.npz"))
    assert step3 == 3 and int(ja3.count) == 3 and int(jm3.num_live()) == 40


def test_resume_from_checkpoint(trained, tmp_path, monkeypatch):
    root, out, first = trained
    ckpt = os.path.join(out, "chkpnt3.npz")
    saved = _npz(ckpt)
    seen = {}
    train = tloop.Trainer.train

    def spy(self, *args, **kwargs):
        if not seen:
            seen.update(step=self.step, count=self.adam.count, sh=self.active_sh_degree,
                        anomaly=torch.is_anomaly_enabled(),
                        mu=self.adam.mu.xyz.clone(), xyz=self.model.xyz.detach().clone())
        return train(self, *args, **kwargs)

    monkeypatch.setattr(tloop.Trainer, "train", spy)
    out2 = str(tmp_path / "resumed")
    trainer = tcli_train.main(["-s", root, "-m", out2, "--start_checkpoint", ckpt,
                               "--detect_anomaly", *TRAIN_FLAGS], device="cpu")
    assert (seen["step"], seen["count"], seen["sh"]) == (3, 3, 0)
    # --detect_anomaly: on for the run, put back after it
    assert seen["anomaly"] is True and torch.is_anomaly_enabled() is False
    np.testing.assert_array_equal(seen["mu"].numpy(), saved["adam.mu/xyz"])
    np.testing.assert_array_equal(seen["xyz"].numpy(), saved["model.params/xyz"])
    assert float(np.abs(saved["adam.mu/xyz"]).max()) > 0.0
    assert trainer.step == 6 and trainer.adam.count == 6
    assert all(bool(torch.isfinite(p).all()) for p in trainer.model.params)
    assert os.path.exists(os.path.join(out2, "point_cloud/iteration_6/point_cloud.ply"))
    # a resume leaves the first run's scene files alone: it writes none
    assert not os.path.exists(os.path.join(out2, "cameras.json"))
    # the camera shuffle starts anew on a resume (as in the JAX package), so the
    # two runs need not end alike; both moved the points from the checkpoint
    assert float((trainer.model.xyz.detach() - seen["xyz"]).abs().max()) > 0.0
    assert float((first.model.xyz.detach() - seen["xyz"]).abs().max()) > 0.0


def _with_view_dependence(out, dst):
    """A copy of the model directory whose splats have random higher SH
    bands (a 6-step run leaves them at zero), so a render at the wrong SH
    degree differs from the diffuse one."""
    shutil.copytree(out, dst)
    ply = os.path.join(dst, "point_cloud", "iteration_6", "point_cloud.ply")
    model = tsplats.load_ply(ply, device="cpu")
    rest = model.params.features_rest
    rest.data = torch.from_numpy(
        np.random.default_rng(7).normal(scale=0.5, size=rest.shape).astype(np.float32))
    tsplats.save_ply(model, ply)
    return dst


def _diffuse_maps(out, caps):
    """The training views of the model directory and the port's own renders
    of them at SH degree 0, as cli.render's mesh branch should fuse them."""
    from tpu2dgs_torch.data.scene import Scene
    from tpu2dgs_torch.raster.api import RasterSettings, render

    args = tcfg.load_cfg_args(out)
    scene = Scene.load(args.source_path, resolution=args.resolution, eval_split=True,
                       shuffle=False)
    model = tsplats.load_ply(os.path.join(out, "point_cloud", "iteration_6", "point_cloud.ply"),
                             device="cpu")
    p = model.params
    cam0 = scene.train_cameras[0]
    settings = RasterSettings(cam0.width, cam0.height, sh_degree=0, **caps)
    maps = {}
    with torch.no_grad():
        for cam in scene.train_cameras:
            o = render(cam.arrays("cpu"), settings, p.xyz, torch.exp(p.scaling), p.rotation,
                       torch.sigmoid(p.opacity[:, 0]), tsplats.features(p),
                       torch.full((3,), float(args.white_background)), live=model.live,
                       device="cpu")
            maps[cam.image_name] = {k: o[k].numpy() for k in ("render", "surf_depth",
                                                             "rend_alpha")}
    return scene.train_cameras, maps


def test_render_and_metrics(trained, tmp_path):
    from PIL import Image

    from tpu2dgs.core.cameras import Camera as JaxCamera
    from tpu2dgs.mesh.extract import GaussianExtractor as JaxExtractor
    from tpu2dgs_torch.eval.geometry import chamfer_distance
    from tpu2dgs_torch.mesh.extract import read_mesh_ply

    _, out, _ = trained
    caps = ["--bin_capacity", "256", "--tile_capacity", "256"]
    model_dir = _with_view_dependence(out, str(tmp_path / "model"))
    mesh_dir = os.path.join(model_dir, "train", "ours_6")
    tcli_render.main(["-m", model_dir, "--skip_train", "--skip_test", "--quiet",
                      "--mesh_res", "32", *caps], device="cpu")
    tcli_render.main(["-m", model_dir, "--skip_train", "--skip_test", "--quiet", "--unbounded",
                      "--mesh_res", "24", "--cull_views", "1", *caps], device="cpu")
    assert sorted(os.listdir(mesh_dir)) == ["fuse.ply", "fuse_post.ply", "fuse_unbounded.ply",
                                            "fuse_unbounded_post.ply"]
    meshes = {name: read_mesh_ply(os.path.join(mesh_dir, name)) for name in os.listdir(mesh_dir)}
    for name, (v, f) in meshes.items():
        assert len(f) > 0 and np.isfinite(v).all() and f.max() < len(v), name
    for name in ("fuse", "fuse_unbounded"):  # post-processing only drops faces
        assert len(meshes[f"{name}_post.ply"][1]) <= len(meshes[f"{name}.ply"][1])

    # fuse.ply against the JAX package's extractor fed the same diffuse
    # maps, at the voxel and truncations tpu2dgs/cli/render.py derives from
    # the cameras' radius and --mesh_res 32
    cams, maps = _diffuse_maps(model_dir, {"bin_capacity": 256, "tile_capacity": 256})
    jex = JaxExtractor(lambda cam: maps[cam.image_name])
    jex.reconstruction([JaxCamera(uid=c.uid, image_name=c.image_name, R=c.R, T=c.T,
                                  fovx=c.fovx, fovy=c.fovy, width=c.width, height=c.height,
                                  alpha_mask=c.alpha_mask) for c in cams])
    depth_trunc = jex.radius * 2.0
    voxel = depth_trunc / 32
    jv, jf, jc = jex.extract_mesh_bounded(voxel_size=voxel, sdf_trunc=5.0 * voxel,
                                          depth_trunc=depth_trunc)
    tv, tf = meshes["fuse.ply"]
    assert abs(len(tf) - len(jf)) <= 5e-3 * len(jf) and len(jf) > 50
    acc, comp, _ = chamfer_distance(tv, jv.astype(np.float32).astype(np.float64))
    assert max(acc, comp) <= 0.01 * voxel, (acc, comp, voxel)
    if len(tf) == len(jf):
        np.testing.assert_array_equal(tf, jf)
    # vertex colours: the diffuse (SH 0) colour, to one 8-bit step
    rgb = tsplats.read_ply_vertices(os.path.join(mesh_dir, "fuse.ply"))
    got = np.stack([rgb["red"], rgb["green"], rgb["blue"]], 1).astype(np.int64)
    want = np.clip(jc * 255.0, 0, 255).astype(np.uint8).astype(np.int64)
    if len(got) == len(want):
        assert np.abs(got - want).max() <= 1
    else:  # each vertex's colour beside the nearest JAX vertex's
        from scipy.spatial import cKDTree

        near = cKDTree(jv).query(tv)[1]
        assert np.mean(np.abs(got - want[near]).max(axis=1) <= 1) > 0.99

    tcli_render.main(["-m", out, "--quiet", "--skip_mesh", "--bin_capacity", "256",
                      "--tile_capacity", "256"], device="cpu")
    for name, n in (("train", 5), ("test", 1)):
        base = os.path.join(out, name, "ours_6")
        assert sorted(os.listdir(os.path.join(base, "renders"))) == \
            [f"{i:05d}.png" for i in range(n)]
        assert sorted(os.listdir(os.path.join(base, "gt"))) == \
            [f"{i:05d}.png" for i in range(n)]
        with Image.open(os.path.join(base, "renders", "00000.png")) as im:
            assert im.size == (64, 48) and im.mode == "RGB"
        with Image.open(os.path.join(base, "vis", "depth_00000.tiff")) as im:
            depth = np.asarray(im)
        assert depth.dtype == np.float32 and depth.shape == (48, 64)
        assert np.isfinite(depth).all()

    tcli_metrics.main(["-m", out], device="cpu")  # LPIPS asked for: said to be unavailable
    with open(os.path.join(out, "results.json")) as f:
        assert json.load(f)["ours_6"]["LPIPS"] is None
    tcli_metrics.main(["-m", out, "--no_lpips"], device="cpu")
    with open(os.path.join(out, "results.json")) as f:
        results = json.load(f)
    with open(os.path.join(out, "per_view.json")) as f:
        per_view = json.load(f)
    assert set(results) == {"ours_6"} and _finite_json(results)
    assert results["ours_6"]["LPIPS"] is None
    assert 0.0 < results["ours_6"]["PSNR"] < 100.0 and -1.0 <= results["ours_6"]["SSIM"] <= 1.0
    assert set(per_view["ours_6"]["PSNR"]) == {"00000.png"}


def test_render_reads_the_backend_from_cfg_args(trained, tmp_path, monkeypatch):
    """A model directory whose cfg_args is written as tpu2dgs.cli.train
    writes it (its parser's backend default is "tiled"; the file keeps the
    model fields) renders through the port; one whose cfg_args holds the
    whole namespace, backend="tiled" in it, as the reference's train.py
    writes, renders through the tiled backend."""
    from tpu2dgs.cli import train as jcli_train
    from tpu2dgs_torch.raster import api as tapi

    root, out, _ = trained
    calls = []
    tiled = tapi.rasterize_tiled
    monkeypatch.setattr(tapi, "rasterize_tiled",
                        lambda *a, **k: calls.append(1) or tiled(*a, **k))
    jargs = jcli_train.build_parser().parse_args(["-s", root, "-m", out, "--eval"])
    assert jargs.backend == "tiled"
    for form in ("jax", "reference"):
        model_dir = str(tmp_path / form)
        shutil.copytree(out, model_dir, ignore=shutil.ignore_patterns("train", "test"))
        jargs.model_path = model_dir
        if form == "jax":
            jcfg.save_cfg_args(model_dir, jargs)
            assert "backend" not in tcfg.load_cfg_args(model_dir)
        else:
            (tmp_path / form / "cfg_args").write_text(repr(argparse.Namespace(**vars(jargs))))
            assert tcfg.load_cfg_args(model_dir).backend == "tiled"
        calls.clear()
        tcli_render.main(["-m", model_dir, "--quiet", "--skip_mesh", "--skip_train"],
                         device="cpu")
        renders = os.listdir(os.path.join(model_dir, "test", "ours_6", "renders"))
        assert renders == ["00000.png"]
        assert len(calls) == (1 if form == "reference" else 0), form


def _crowded(out, dst, reps=16):
    """A copy of the model directory whose splats are repeated `reps` times,
    jittered, three times as large and faint (opacity 0.03), so the cuda
    backend's 16x128 tiles hold more than its least tile capacity (128)
    and what a list drops shows in the render."""
    shutil.copytree(out, dst, ignore=shutil.ignore_patterns("train", "test"))
    ply = os.path.join(dst, "point_cloud", "iteration_6", "point_cloud.ply")
    model = tsplats.load_ply(ply, device="cpu")
    p, live = model.params, model.live
    n = int(live.sum()) * reps
    jitter = np.random.default_rng(8).normal(scale=0.05, size=(n, 3)).astype(np.float32)
    scene = (p.xyz[live].repeat(reps, 1) + torch.from_numpy(jitter),
             3.0 * torch.exp(p.scaling[live]).repeat(reps, 1), p.rotation[live].repeat(reps, 1),
             torch.full((n,), 0.03), tsplats.features(p)[live].repeat(reps, 1, 1))
    tsplats.save_ply(synthetic.scene_model([a.detach() for a in scene]), ply)
    return dst


def test_render_at_the_gate_demand_capacities(trained, tmp_path):
    """cli.render heals its capacities: on a model whose cuda tiles hold
    more splats than the least tile capacity (128), its renders at
    --bin_capacity 8 --tile_capacity 8 equal, byte for byte, the renders at
    capacities with room for every list, and the caps it returns are at
    least the largest demand of any view, read from the overflow counters
    at those room capacities."""
    from PIL import Image

    from tpu2dgs_torch.data.scene import Scene
    from tpu2dgs_torch.raster import api as tapi

    _, out, _ = trained
    model_dir = _crowded(out, str(tmp_path / "crowded"))
    room = dict(bin_capacity=4096, tile_capacity=4096, col_capacity=32768)
    views, returned = {}, {}
    for name, caps in (("room", [f"--{k}={v}" for k, v in room.items()]),
                       ("tight", ["--bin_capacity", "8", "--tile_capacity", "8"])):
        returned[name] = tcli_render.main(["-m", model_dir, "--quiet", "--skip_mesh",
                                           "--skip_train", *caps], device="cpu")
        with Image.open(os.path.join(model_dir, "test", "ours_6", "renders", "00000.png")) as im:
            views[name] = np.asarray(im)
    np.testing.assert_array_equal(views["tight"], views["room"])
    assert returned["room"] == room

    args = tcfg.load_cfg_args(model_dir)
    scene = Scene.load(args.source_path, resolution=args.resolution, eval_split=True,
                       shuffle=False)
    model = tsplats.load_ply(os.path.join(model_dir, "point_cloud", "iteration_6",
                                          "point_cloud.ply"), device="cpu")
    p = model.params
    for cam in scene.test_cameras:
        with torch.no_grad():
            demand = tapi.render(cam.arrays("cpu"), tapi.RasterSettings(
                cam.width, cam.height, **room), p.xyz, torch.exp(p.scaling), p.rotation,
                torch.sigmoid(p.opacity[:, 0]), tsplats.features(p), torch.zeros(3),
                live=model.live, device="cpu")
        assert float(demand["tile_count_max"]) > 128
        for kwarg in room:
            assert returned["tight"][kwarg] >= float(demand[kwarg.replace("capacity",
                                                                          "count_max")])


def test_train_tiled_heals_a_tile_overflow(trained, tmp_path):
    """--backend tiled trains, and its overflow counters raise the tile
    capacity through the Trainer's adaptive caps."""
    root, _, _ = trained
    trainer = tcli_train.main(["-s", root, "-m", str(tmp_path / "tiled"), *TRAIN_FLAGS,
                               "--backend", "tiled", "--tile_capacity", "4",
                               "--densification_interval", "2"], device="cpu")
    assert trainer.step == 6 and trainer.adam.count == 6
    assert trainer.raster_kwargs["backend"] == "tiled"
    assert trainer._settings().tile_px == 16 and trainer._settings().chunk == 32
    grown = [(it, new) for it, kwarg, new in trainer.cap_growth_events
             if kwarg == "tile_capacity"]
    assert grown and grown[0][0] == 2 and trainer.raster_kwargs["tile_capacity"] >= 128
    assert all(bool(torch.isfinite(p).all()) for p in trainer.model.params)
    assert os.path.exists(tmp_path / "tiled" / "point_cloud" / "iteration_6" / "point_cloud.ply")
