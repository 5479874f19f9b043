"""Tile-row multi-device rendering and training of the port: two gloo ranks
on the CPU (parallel.distributed.spawn; the ranks run functions of
parallel/rehearsal.py) against the JAX package's two-device render on the
conftest's virtual devices and against the port on one device.

  * render(mesh=) on the cuda backend (its plain versions) with static
    strips and with work windows, and on the tiled backend: the render keys
    within 2e-4 of JAX's render(mesh=make_mesh(2)) and of the port's
    single-device render, radii and demand counters equal to JAX's, both
    ranks bit-equal; the gradients of a loss through every map (the one of
    tests/test_sharded.py) after the all-reduce within rtol 3e-3 / atol
    3e-5 of one device's; in work mode every rank's buffers shorter than
    the image;
  * a two-rank Trainer against the single-device Trainer (as
    tests/test_multichip_train.py does): losses at rtol 2e-3, positions at
    atol 2e-5 before densification, the same live count and capacity after
    it and positions within 5e-3 at the 95th percentile, both ranks
    bit-equal throughout;
  * cli.train --n_devices 2 on the CPU writing one model directory, its PLY
    within tests/test_multichip_train.py's long-horizon rule of the
    single-device run's.

The overflow fractions are not compared with JAX in work mode: JAX averages
them over a full-height grid on every device, the port over its window.
PyTorch runs on one thread (`one_torch_thread`), and so does each rank.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_data import _make_colmap_dataset
from tests.test_tiled import _random_scene, _settings
from tests.test_torch_cli import TRAIN_FLAGS
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.core import cameras as jcam
from tpu2dgs.parallel.sharded import make_mesh
from tpu2dgs.raster.api import render as jrender
from tpu2dgs_torch.cli import train as tcli_train
from tpu2dgs_torch.core import cameras as tcam
from tpu2dgs_torch.core import sh as tsh
from tpu2dgs_torch.model import splats as tsplats
from tpu2dgs_torch.parallel import distributed, rehearsal
from tpu2dgs_torch.raster import api as tapi
from tpu2dgs_torch.train.loop import TrainConfig

W, H = 150, 160  # 2 x 10 tiles of 16 x 128: the windows split inside a coarse-bin row
BG = np.array([0.2, 0.1, 0.0], np.float32)
CAPS = dict(bin_capacity=256, tile_capacity=128)
MODES = {"static": dict(backend="cuda", row_balance="static"),
         "work": dict(backend="cuda", row_balance="work"),
         "tiled": dict(backend="tiled")}
COUNTERS = {"static": ("tile_count_max", "bin_count_max", "col_count_max", "grad_pack_max",
                       "strip_work", "tile_overflow_frac", "bin_overflow_frac"),
            "work": ("tile_count_max", "bin_count_max", "col_count_max", "grad_pack_max",
                     "strip_work"),
            "tiled": ("tile_count_max", "bin_count_max", "strip_work")}
CPU = torch.device("cpu")


def _camera():
    return dict(uid=0, image_name="t", R=np.eye(3), T=np.zeros(3), fovx=np.pi / 2,
                fovy=np.pi / 2, width=W, height=H)


@pytest.fixture(scope="module")
def renders():
    """The scene through two gloo ranks (every mode in one run), through
    the port on one device and through JAX on a two-device mesh."""
    scene = tuple(np.asarray(a) for a in _random_scene(n=150, seed=3))
    cam = tcam.Camera(**_camera())
    settings = [tapi.RasterSettings(W, H, **CAPS, **kw) for kw in MODES.values()]
    ranks = distributed.spawn(rehearsal.render_rank, 2,
                              args=(cam, settings, scene, BG, True), device="cpu",
                              timeout_s=600)
    one = [rehearsal.render_once(cam, s, scene, BG, CPU, plain=True) for s in settings]
    jcamera = jcam.Camera(**_camera()).arrays()
    mesh = make_mesh(2)
    jax_out = []
    for kw in MODES.values():
        jset = _settings(W, H, "pallas" if kw["backend"] == "cuda" else "tiled", debug=True,
                         **CAPS, **{k: v for k, v in kw.items() if k != "backend"})
        out = jax.jit(lambda *a, js=jset: jrender(jcamera, js, *a, jnp.asarray(BG),
                                                  mesh=mesh))(*scene)
        jax_out.append({k: np.asarray(v) for k, v in out.items()})
    return {mode: dict(ranks=[r[i] for r in ranks], one=one[i], jax=jax_out[i])
            for i, mode in enumerate(MODES)}


@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_render_matches_jax_and_one_device(renders, mode):
    r = renders[mode]
    got, one, want = r["ranks"][0], r["one"], r["jax"]
    for k, v in got.items():
        if k not in ("launches", "seconds"):
            np.testing.assert_array_equal(r["ranks"][1][k], v, err_msg=f"ranks differ: {k}")
    for k in rehearsal.KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-4, err_msg=k)
        np.testing.assert_allclose(got[k], one[k], rtol=2e-4, atol=2e-4, err_msg=k)
    for k in ("radii", *COUNTERS[mode]):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["strip_work"].shape == (2,) and float(got["strip_work"].sum()) > 0
    for p in rehearsal.PARAMS:
        g, g1 = got[f"grad_{p}"], one[f"grad_{p}"]
        assert float(np.abs(g1).max()) > 0.0, p
        np.testing.assert_allclose(g, g1, rtol=3e-3, atol=3e-5, err_msg=p)
    if mode == "work":
        # each rank's buffers hold its window and at most 3 tile rows before
        # it, never the full height
        assert (got["strip_rows"] < H).all(), got["strip_rows"]
        assert got["strip_work"].min() > 0  # both windows carry work


def _orbit(uid, angle, w, h, radius=3.0):
    # tests/test_train.py::_orbit_camera, for the port's Camera
    fwd = np.array([-np.sin(angle), 0.0, -np.cos(angle)])
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right = right / np.linalg.norm(right)
    rw2v = np.stack([right, np.cross(fwd, right), fwd])
    return tcam.Camera(uid=uid, image_name=f"v{uid}", R=rw2v.T, T=rw2v @ (radius * fwd),
                       fovx=np.pi / 3, fovy=np.pi / 3, width=w, height=h)


def test_sharded_trainer_matches_one_device():
    w, h = 64, 128  # 8 tile rows: both ranks blend
    rng = np.random.default_rng(5)
    n = 16
    gt = (rng.uniform(-0.5, 0.5, (n, 3)), np.exp(rng.uniform(-2.0, -1.4, (n, 2))),
          rng.normal(size=(n, 4)), rng.uniform(0.6, 0.95, (n,)))
    rgb = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    feats = np.zeros((n, 16, 3), np.float32)
    feats[:, 0] = tsh.rgb_to_sh(torch.from_numpy(rgb)).numpy()
    gt = tuple(torch.tensor(np.asarray(a, np.float32)) for a in (*gt, feats))
    cams = [_orbit(i, a, w, h) for i, a in enumerate(np.linspace(0, 2 * np.pi, 6,
                                                                 endpoint=False))]
    settings = tapi.RasterSettings(w, h, sh_degree=0, **CAPS)
    with torch.no_grad():
        for c in cams:
            c.image = tapi.render(c.arrays(CPU), settings, *gt, torch.zeros(3),
                                  device=CPU)["render"].numpy()
    start = gt[0].numpy() + np.random.default_rng(3).normal(scale=0.04, size=(n, 3))
    model = rehearsal.model_arrays(tsplats.create_from_pcd(start.astype(np.float32), rgb,
                                                           capacity=64, device=CPU))
    cfg = TrainConfig(densify_from_iter=5, densify_until_iter=80, densification_interval=6,
                      opacity_reset_interval=10_000, normal_from_iter=2, dist_from_iter=3,
                      lambda_normal=0.01, lambda_dist=10.0)
    kw = dict(spatial_lr_scale=1.0, scene_extent=3.0, train_cfg=cfg, max_sh_degree=0,
              raster_kwargs=dict(CAPS), seed=1)
    stops = (5, 8)  # densification at step 6
    one = rehearsal.train_once(model, cams, w, h, stops, kw, CPU)
    ranks = distributed.spawn(rehearsal.train_rank, 2, args=(model, cams, w, h, stops, kw),
                              device="cpu", timeout_s=600)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=2e-3, atol=1e-7)
    assert ranks[0]["loss"] == ranks[1]["loss"]
    for a, b in zip(*(r["stops"] for r in ranks)):
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k], err_msg=k)
    before, after = ranks[0]["stops"]
    one_before, one_after = one["stops"]
    np.testing.assert_allclose(before["params"]["xyz"], one_before["params"]["xyz"], atol=2e-5)
    assert after["num_live"] == one_after["num_live"] > before["num_live"]
    assert after["capacity"] == one_after["capacity"]
    diff = np.abs(after["params"]["xyz"] - one_after["params"]["xyz"])
    assert float(np.quantile(diff, 0.95)) < 5e-3, float(diff.max())


def test_cli_train_two_ranks_writes_one_model(tmp_path):
    root = str(tmp_path / "scene")
    os.makedirs(root)
    _make_colmap_dataset(root, n_views=6, n_pts=40)  # 64x48, the JAX package's writers
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    single = tcli_train.main(["-s", root, "-m", one, *TRAIN_FLAGS], device="cpu")
    assert tcli_train.main(["-s", root, "-m", two, "--n_devices", "2", *TRAIN_FLAGS],
                           device="cpu") is None
    plys = [os.path.join(d, f) for d, _, fs in os.walk(two) for f in fs if f.endswith(".ply")]
    ply = os.path.join(two, "point_cloud", "iteration_6", "point_cloud.ply")
    assert sorted(plys) == sorted([ply, os.path.join(two, "input.ply")])
    for name in ("cfg_args", "cameras.json", "metrics.jsonl"):
        assert os.path.exists(os.path.join(two, name)), name
    with open(os.path.join(one, "metrics.jsonl")) as a, \
            open(os.path.join(two, "metrics.jsonl")) as b:
        assert len(a.readlines()) == len(b.readlines())  # rank 0 alone logged
    m = tsplats.load_ply(ply, device=CPU)
    assert int(m.num_live()) == int(single.model.num_live()) == 40
    live = single.model.live.numpy()
    # Adam's first steps move a coordinate by lr * sign(g), so a gradient of
    # float32 noise (the two ranks sum their rows' parts in another order)
    # steps either way: tests/test_multichip_train.py's long-horizon rule
    diff = np.abs(m.xyz.detach().numpy()[:40] - single.model.xyz.detach().numpy()[live])
    assert float(np.quantile(diff, 0.95)) < 5e-3, float(diff.max())


def test_launched_rank_joins_on_the_callers_device(monkeypatch):
    """Under a launcher (WORLD_SIZE > 1), initialize(device) takes the
    device the caller resolved: gloo for the CPU even where there is a GPU,
    NCCL on cuda:LOCAL_RANK otherwise."""
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: seen.append(("set_device", d)))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: seen.append((backend, kw["rank"],
                                                           kw["world_size"])))
    for k, v in (("WORLD_SIZE", "2"), ("RANK", "1"), ("LOCAL_RANK", "1")):
        monkeypatch.setenv(k, v)
    distributed.initialize(torch.device("cpu"))
    assert seen == [("gloo", 1, 2)]
    seen.clear()
    distributed.initialize(torch.device("cuda"))
    assert seen == [("set_device", torch.device("cuda", 1)), ("nccl", 1, 2)]
