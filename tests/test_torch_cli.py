"""tpu2dgs_torch command line, checkpoints and config against tpu2dgs.

  * cfg_args: the port's round trip, a file written by the JAX package's
    save_cfg_args read by the port, the backend names, every flag of the
    JAX parsers' test;
  * checkpoints both ways, every array bit-equal under the same keys;
  * the pipeline on the CPU (the kernels' plain versions): cli.train on a
    COLMAP dataset written by the JAX package's writers, a resume from its
    checkpoint, cli.render's bounded and unbounded meshes (the bounded one
    held against the JAX package's extractor fed the port's diffuse maps),
    cli.render --skip_mesh, cli.metrics --no_lpips, and the model directory
    read back by the JAX package;
  * cli.render of a model directory whose cfg_args the JAX package's
    cli.train wrote, and of one that names the tiled backend; cli.train
    --backend tiled, its tile capacity healed after an overflow;
  * gt_cache_mb: host-resident ground truth gives the pre-staged run's
    losses exactly;
  * the Morton KNN: bit-equal to the JAX package's (same source and flags),
    and chosen by create_from_pcd above 65,536 points.

The JAX side here is numpy readers and writers, eager array code and one
TSDF fusion: no render or train step is compiled.
"""

import argparse
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_data import _make_colmap_dataset
from tpu2dgs import native as jnative
from tpu2dgs.cli import config as jcfg
from tpu2dgs.model import optim as joptim
from tpu2dgs.model import splats as jsplats
from tpu2dgs.train import checkpoint as jckpt
from tpu2dgs_torch.cli import config as tcfg
from tpu2dgs_torch.cli import convert as tcli_convert
from tpu2dgs_torch.cli import metrics as tcli_metrics
from tpu2dgs_torch.cli import render as tcli_render
from tpu2dgs_torch.cli import train as tcli_train
from tpu2dgs_torch.eval import synthetic
from tpu2dgs_torch.model import optim as toptim
from tpu2dgs_torch.model import splats as tsplats
from tpu2dgs_torch.native import knn as tknn
from tpu2dgs_torch.train import checkpoint as tckpt
from tpu2dgs_torch.train import loop as tloop

MODEL_NS = dict(sh_degree=3, source_path="/data/lego", model_path="", images="images",
                resolution=2, white_background=True, data_device="cuda", eval=True)


# -- config -------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax", "reference"])
def test_cfg_args_read_by_port(tmp_path, writer):
    ns = argparse.Namespace(**{**MODEL_NS, "model_path": str(tmp_path)}, iterations=7)
    if writer == "port":
        tcfg.save_cfg_args(str(tmp_path), ns)
    elif writer == "jax":
        jcfg.save_cfg_args(str(tmp_path), ns)
    else:
        (tmp_path / "cfg_args").write_text(
            "Namespace(data_device='cuda', eval=True, images='images', "
            f"model_path='{tmp_path}', resolution=2, sh_degree=3, "
            "source_path='/data/lego', white_background=True)")
    loaded = tcfg.load_cfg_args(str(tmp_path))
    assert vars(loaded) == {**MODEL_NS, "model_path": str(tmp_path)}
    # both packages write the same file, so it passes both ways
    assert vars(jcfg.load_cfg_args(str(tmp_path))) == vars(loaded)
    merged = tcfg.get_combined_args(tcli_render.build_parser(),
                                    ["-m", str(tmp_path), "--skip_mesh", "-r", "4"])
    assert merged.source_path == "/data/lego" and merged.eval is True
    assert merged.resolution == 4  # the command line wins over the file
    assert tcfg.extract(tcfg.RasterParams, merged).backend == "cuda"


def test_backend_names(tmp_path, capsys):
    assert tcfg.RasterParams().backend == "cuda"
    assert tcfg.port_backend("cuda") == "cuda"
    assert tcfg.port_backend("pallas") == "cuda"
    assert '"pallas"' in capsys.readouterr().out  # the CLI says that it did so
    for name in ("tiled", "oracle"):  # the JAX package's default and its spec
        assert tcfg.port_backend(name) == name
    with pytest.raises(ValueError):
        tcfg.port_backend("vulkan")
    # a hand-written cfg_args that names the JAX package's backend
    (tmp_path / "cfg_args").write_text("Namespace(backend='pallas', sh_degree=3)")
    assert tcfg.load_cfg_args(str(tmp_path)).backend == "cuda"
    (tmp_path / "cfg_args").write_text("not a namespace")
    with pytest.raises(ValueError):
        tcfg.load_cfg_args(str(tmp_path))


def test_parsers_accept_the_jax_flags():
    """Every flag tests/test_cli.py gives the JAX parser, and every option
    the JAX parsers define, parses in the port with the same default."""
    args = tcli_train.build_parser().parse_args([
        "-s", "/data/x", "-m", "/out/y", "-r", "2", "-w", "--iterations", "7000",
        "--lambda_dist", "1000", "--depth_ratio", "1", "--eval"])
    assert (args.source_path, args.resolution, args.white_background) == ("/data/x", 2, True)
    assert (args.iterations, args.lambda_dist, args.depth_ratio) == (7000, 1000.0, 1.0)

    from tpu2dgs.cli import render as jcli_render
    from tpu2dgs.cli import train as jcli_train

    for jparser, tparser in ((jcli_train.build_parser(), tcli_train.build_parser()),
                             (jcli_render.build_parser(), tcli_render.build_parser())):
        jopts = {a.dest: a for a in jparser._actions}
        topts = {a.dest: a for a in tparser._actions}
        assert set(jopts) == set(topts)
        for dest, ja in jopts.items():
            assert set(ja.option_strings) == set(topts[dest].option_strings), dest
            if dest != "backend":  # "tiled" there; "cuda" here, or cfg_args' in render
                assert ja.default == topts[dest].default, dest


def test_unported_arguments_raise(tmp_path, monkeypatch):
    """--n_devices N runs (tile rows, tests/test_torch_sharded.py; splats,
    tests/test_torch_splat_sharded.py) and refuses what it cannot run
    before anything is written: more ranks than GPUs, 0 (every GPU) on the
    CPU, and splat sharding off the cuda backend."""
    base = ["-s", str(tmp_path), "-m", str(tmp_path / "out"), "--disable_viewer"]
    with pytest.raises(ValueError, match="--shard_mode splats needs the cuda backend"):
        tcli_train.main(base + ["--n_devices", "2", "--shard_mode", "splats", "--backend",
                                "tiled"], device="cpu")
    with pytest.raises(ValueError, match="counts GPUs"):
        tcli_train.main(base + ["--n_devices", "0"], device="cpu")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tcli_train.main(base + ["--n_devices", "2"])  # the GPU run, where there is none
    with monkeypatch.context() as m:  # one GPU: no fallback to fewer ranks
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(RuntimeError, match="2 ranks need 2 GPUs; this host has 1"):
            tcli_train.main(base + ["--n_devices", "2"])
    assert not (tmp_path / "out").exists()  # refused before anything was written
    # --shard_mode splats with one rank trains unsharded, as in the JAX package
    scene = tmp_path / "scene"
    scene.mkdir()
    _make_colmap_dataset(str(scene), n_views=6, n_pts=40)
    one = tcli_train.main(["-s", str(scene), "-m", str(tmp_path / "one"), "--shard_mode",
                           "splats", *TRAIN_FLAGS, "--iterations", "1"], device="cpu")
    assert one.step == 1 and not one.shard_splats and one.model.capacity == 4096
    assert tcli_convert.main.__defaults__ == (None, None)  # main(argv=None, device=None)


# -- checkpoints ----------------------------------------------------------------


def _jax_state(seed=5, n=20, cap=32):
    rng = np.random.default_rng(seed)
    model = jsplats.create_from_pcd(rng.normal(size=(n, 3)).astype(np.float32),
                                    rng.random((n, 3)).astype(np.float32), capacity=cap)
    model = model._replace(
        max_radii2d=jnp.asarray(rng.random(cap), jnp.float32),
        grad_accum=jnp.asarray(rng.random(cap), jnp.float32),
        denom=jnp.asarray(rng.integers(0, 9, cap), jnp.float32))
    like = model.params
    adam = joptim.AdamState(
        count=jnp.int32(11),
        mu=jsplats.SplatParams(*(jnp.asarray(rng.normal(size=a.shape), jnp.float32)
                                 for a in like)),
        nu=jsplats.SplatParams(*(jnp.asarray(rng.random(a.shape), jnp.float32)
                                 for a in like)))
    return model, adam


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_checkpoints_pass_both_ways(tmp_path):
    jm, ja = _jax_state()
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_checkpoint(jpath, jm, ja, 1234, {"ema": 0.5})

    model, adam, step, extra = tckpt.load_checkpoint(jpath, device="cpu")
    assert step == 1234 and adam.count == 11 and float(extra["ema"]) == 0.5
    assert isinstance(model, tsplats.SplatModel) and isinstance(adam, toptim.AdamState)
    np.testing.assert_array_equal(model.xyz.detach().numpy(), np.asarray(jm.params.xyz))
    np.testing.assert_array_equal(adam.nu.rotation.numpy(), np.asarray(ja.nu.rotation))

    tckpt.save_checkpoint(tpath, model, adam, step, {"ema": 0.5})
    want, got = _npz(jpath), _npz(tpath)
    assert set(want) == set(got)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not os.path.exists(tpath + ".tmp.npz")  # written under a temporary name

    jm2, ja2, step2, extra2 = jckpt.load_checkpoint(tpath)
    assert step2 == 1234 and int(ja2.count) == 11 and float(extra2["ema"]) == 0.5
    for a, b in zip(jm2.params, jm.params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip((*ja2.mu, *ja2.nu), (*ja.mu, *ja.nu)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(jm2.live), np.asarray(jm.live))
    np.testing.assert_array_equal(np.asarray(jm2.denom), np.asarray(jm.denom))


# -- the pipeline ---------------------------------------------------------------

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
    """cli.render renders at its flags' capacities: on a model whose cuda
    tiles hold more splats than the least tile capacity (128), its renders at
    --tile_capacity 8 drop what the lists cannot hold; at the flags that
    eval.quality_gate.demand_flags reads from the model's demand they equal
    the renders at capacities with room for every list."""
    from PIL import Image

    from tpu2dgs_torch.data.scene import Scene
    from tpu2dgs_torch.eval import quality_gate as tq

    _, out, _ = trained
    model_dir = _crowded(out, str(tmp_path / "crowded"))
    args = tcfg.load_cfg_args(model_dir)
    scene = Scene.load(args.source_path, resolution=args.resolution, eval_split=True,
                       shuffle=False)
    model = tsplats.load_ply(os.path.join(model_dir, "point_cloud", "iteration_6",
                                          "point_cloud.ply"), device="cpu")
    demand = tq.demand_flags(model, scene.train_cameras + scene.test_cameras,
                             torch.device("cpu"))
    assert demand[::2] == ["--backend", "--bin_capacity", "--tile_capacity", "--col_capacity"]
    assert demand[1] == "cuda" and int(demand[5]) > 128
    views = {}
    for name, caps in (("room", ["--bin_capacity", "4096", "--tile_capacity", "4096"]),
                       ("tight", ["--bin_capacity", "8", "--tile_capacity", "8"]),
                       ("demand", demand)):
        tcli_render.main(["-m", model_dir, "--quiet", "--skip_mesh", "--skip_train", *caps],
                         device="cpu")
        with Image.open(os.path.join(model_dir, "test", "ours_6", "renders", "00000.png")) as im:
            views[name] = np.asarray(im)
    assert not np.array_equal(views["tight"], views["room"])
    np.testing.assert_array_equal(views["demand"], views["room"])


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


# -- ground truth over the budget -------------------------------------------------


def test_gt_cache_budget_gives_the_same_losses():
    w, h = 64, 48
    caps = dict(bin_capacity=256, tile_capacity=256)
    runs = {}
    for budget in (None, 1e-3):
        cams, model = synthetic.make_shell_training_set(w, h, 200, views=3, device="cpu",
                                                        **caps)
        losses = []
        tr = tloop.Trainer(model, cams, w, h, spatial_lr_scale=1.0, scene_extent=1.0,
                           raster_kwargs=caps, gt_cache_mb=budget,
                           train_cfg=tloop.TrainConfig(camera_batch=2),
                           log_fn=lambda it, m: losses.append(float(m["loss"])))
        assert tr.gt_prestaged == (budget is None)
        tr.train(num_iters=6)
        runs[budget] = losses
        if budget is not None:
            # copies of the views the shuffle asks for next are under way
            assert 0 < len(tr._gt_prefetch) <= 3
            assert set(tr._gt_prefetch) <= set(tr._peek_camera_indices(3)) | {0, 1, 2}
    assert len(runs[None]) == 6 and all(np.isfinite(runs[None]))
    assert runs[None] == runs[1e-3]


# -- Morton KNN -------------------------------------------------------------------


def test_morton_knn_matches_jax_package(monkeypatch):
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(70_000, 3)).astype(np.float32)
    got = tknn.knn_mean_dist2(pts)
    np.testing.assert_array_equal(got, jnative.knn_mean_dist2(pts))
    assert got.shape == (70_000,) and np.isfinite(got).all() and (got > 0).all()
    with pytest.raises(ValueError):
        tknn.knn_mean_dist2(pts[:, :2])

    calls = []
    real = tknn.knn_mean_dist2
    monkeypatch.setattr(tknn, "knn_mean_dist2",
                        lambda p, *a, **k: (calls.append(p.shape[0]), real(p, *a, **k))[1])
    small = tsplats.create_from_pcd(pts[:300], np.full((300, 3), 0.5, np.float32),
                                    device="cpu")
    assert calls == []  # the exact sweep below the threshold
    n = tsplats.MORTON_KNN_ABOVE + 1
    big = tsplats.create_from_pcd(pts[:n], np.full((n, 3), 0.5, np.float32), device="cpu")
    assert calls == [n] and int(small.num_live()) == 300
    want = np.log(np.sqrt(np.clip(jnative.knn_mean_dist2(pts[:n]), 1e-7, None)))
    np.testing.assert_allclose(big.scaling.detach().numpy()[:n, 0], want, rtol=1e-6)
    jbig = jsplats.create_from_pcd(pts[:n], np.full((n, 3), 0.5, np.float32))
    np.testing.assert_allclose(big.scaling.detach().numpy(), np.asarray(jbig.params.scaling),
                               rtol=1e-6, atol=1e-6)
