"""tpu2dgs_torch command line, checkpoints and config against tpu2dgs.

  * cfg_args: the port's round trip, a file written by the JAX package's
    save_cfg_args read by the port, the backend names, every flag of the
    JAX parsers' test;
  * checkpoints both ways, every array bit-equal under the same keys;
  * the pipeline on the CPU (the kernels' plain versions): cli.train on a
    COLMAP dataset written by the JAX package's writers, a resume from its
    checkpoint, cli.render --skip_mesh, cli.metrics --no_lpips, and the
    model directory read back by the JAX package;
  * gt_cache_mb: host-resident ground truth gives the pre-staged run's
    losses exactly;
  * the Morton KNN: bit-equal to the JAX package's (same source and flags),
    and chosen by create_from_pcd above 65,536 points.

The JAX side here is numpy readers and writers and eager array code: no
render or train step is compiled.
"""

import argparse
import json
import os

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
    for name in ("tiled", "oracle"):
        with pytest.raises(NotImplementedError, match="--backend cuda"):
            tcfg.port_backend(name)
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
            if dest != "backend":  # "tiled" there, "cuda" here
                assert ja.default == topts[dest].default, dest


def test_unported_arguments_raise(tmp_path):
    base = ["-s", str(tmp_path), "-m", str(tmp_path / "out"), "--disable_viewer"]
    for extra, slice_name in ((["--n_devices", "2"], "multi-device"),
                              (["--n_devices", "0"], "multi-device"),
                              (["--shard_mode", "splats"], "multi-device"),
                              (["--backend", "tiled"], "backend"),
                              (["--backend", "oracle"], "backend")):
        with pytest.raises(NotImplementedError, match=slice_name):
            tcli_train.main(base + extra, device="cpu")
    assert not (tmp_path / "out").exists()  # refused before anything was written
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


def test_render_and_metrics(trained):
    from PIL import Image

    _, out, _ = trained
    with pytest.raises(NotImplementedError, match="--skip_mesh"):
        tcli_render.main(["-m", out, "--quiet"], device="cpu")
    assert not os.path.exists(os.path.join(out, "train"))  # raised before writing anything
    assert not os.path.exists(os.path.join(out, "test"))

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
