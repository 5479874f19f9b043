"""tpu2dgs_torch's Trainer against tpu2dgs's: a 5-step run of each (Pallas
backend in interpret mode on the JAX side, same seed, same camera order),
its metrics, state and capacity healing, the batched step's reductions,
and the profile window. One run of each Trainer serves every test here
(the `trainers` fixture). The losses, the optimizer, the model utilities
and densification are held in tests/test_torch_train_{losses,optim,model,
densify}.py.

The JAX Trainer's step returns the Adam state it was given, not the one
adam_step produced (tpu2dgs/train/loop.py:209-220), so its count stays 0
and every step is Adam's first: lr * sign(g). The port's Trainer carries
the state. The 5-step run is therefore compared with the port's Trainer
made to drop the state the same way, and the port's own run is checked to
carry it; adam_step itself is held against JAX over several steps in
tests/test_torch_train_optim.py.

Tolerances: 1e-6 where the arithmetic is elementwise float32; the
training run's loss per step at rtol 2e-3 (the repo's gradient tolerance is 3e-3, and Adam's first
steps are lr * sign(g))."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_core import to_torch
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tests.test_train import _gt_scene, _orbit_camera
from tpu2dgs.model import splats as jsplats
from tpu2dgs.train import loop as jloop
from tpu2dgs_torch.core import cameras as tcam
from tpu2dgs_torch.model import optim as toptim
from tpu2dgs_torch.model import splats as tsplats
from tpu2dgs_torch.parallel.distributed import Mesh
from tpu2dgs_torch.raster import api as tapi
from tpu2dgs_torch.train import loop as tloop
from tpu2dgs_torch.viewer import network_gui

FIELDS = jsplats.SplatParams._fields


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=1e-6, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol, err_msg=msg)


# -- the trainer ------------------------------------------------------------

W = H = 48
CAPS = dict(bin_capacity=128, tile_capacity=128)
STEPS = 5


def _run_trainers(steps):
    """Both packages' Trainers after `steps` steps on the same scene, with
    all three loss terms on, and the metrics each logged."""
    gt_splats, gt_xyz, gt_rgb = _gt_scene(n=24, seed=0)
    jcams = [_orbit_camera(i, a, w=W, h=H)
             for i, a in enumerate(np.linspace(0, 2 * np.pi, 4, endpoint=False))]
    tcams = [tcam.Camera(uid=c.uid, image_name=c.image_name, R=c.R, T=c.T, fovx=c.fovx,
                         fovy=c.fovy, width=W, height=H) for c in jcams]
    settings = tapi.RasterSettings(W, H, sh_degree=0, **CAPS)
    with torch.no_grad():
        for jc, tc in zip(jcams, tcams):
            out = tapi.render(tc.arrays("cpu"), settings, *map(to_torch, gt_splats),
                              torch.zeros(3), device="cpu")
            jc.image = tc.image = out["render"].numpy()
    rng = np.random.default_rng(7)
    pts = gt_xyz + rng.normal(scale=0.05, size=gt_xyz.shape).astype(np.float32)
    rgb = np.clip(gt_rgb + rng.normal(scale=0.2, size=gt_rgb.shape), 0.05, 0.95).astype(np.float32)
    kw = dict(normal_from_iter=0, dist_from_iter=0, lambda_dist=100.0, lambda_normal=0.05)
    logs = {"jax": [], "port": [], "port_carrying": []}
    jt = jloop.Trainer(
        jsplats.create_from_pcd(pts, rgb, capacity=32), jcams, W, H, spatial_lr_scale=1.0,
        scene_extent=3.0, train_cfg=jloop.TrainConfig(**kw), max_sh_degree=0, seed=1,
        raster_kwargs=dict(backend="pallas", debug=True, **CAPS),
        log_fn=lambda it, m: logs["jax"].append({k: float(v) for k, v in m.items()}))

    def port_trainer(log):
        return tloop.Trainer(
            tsplats.create_from_pcd(pts, rgb, capacity=32, device="cpu"), tcams, W, H,
            spatial_lr_scale=1.0, scene_extent=3.0, train_cfg=tloop.TrainConfig(**kw),
            max_sh_degree=0, seed=1, raster_kwargs=dict(CAPS),
            log_fn=lambda it, m: log.append({k: float(v) for k, v in m.items()}))

    real_step = tloop.train_step

    def dropping_step(settings, opt_cfg, lambda_dssim, lr_scale, model, adam, *args):
        model, _, metrics = real_step(settings, opt_cfg, lambda_dssim, lr_scale, model,
                                      toptim.init_adam(model.params), *args)
        return model, adam, metrics

    jt.train(num_iters=steps)
    tt = port_trainer(logs["port"])
    with mock.patch.object(tloop, "train_step", dropping_step):
        tt.train(num_iters=steps)
    tc = port_trainer(logs["port_carrying"])
    tc.train(num_iters=steps)
    return jt, tt, tc, logs


@pytest.fixture(scope="module")
def trainers():
    return _run_trainers(STEPS)


@pytest.mark.parametrize("key", ["loss", "l1", "normal", "dist", "num_visible",
                                 "tile_count_max", "grad_pack_max"])
def test_trainer_run_matches_jax(trainers, key):
    _, _, _, logs = trainers
    assert len(logs["port"]) == len(logs["jax"]) == STEPS
    got = [m[key] for m in logs["port"]]
    want = [m[key] for m in logs["jax"]]
    if key in ("num_visible", "tile_count_max", "grad_pack_max"):
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-7, err_msg=key)


def test_trainer_state_matches_jax(trainers):
    jt, tt, _, logs = trainers
    assert tt.step == jt.step == STEPS
    assert set(logs["port"][0]) == set(logs["jax"][0])
    assert tt.active_sh_degree == jt.active_sh_degree == 0
    np.testing.assert_allclose(tt.ema_loss, jt.ema_loss, rtol=2e-3)
    # statistics: the same splats were visible in the same steps
    np.testing.assert_array_equal(_np(tt.model.denom), _np(jt.model.denom))
    np.testing.assert_array_equal(_np(tt.model.max_radii2d), _np(jt.model.max_radii2d))
    # Every step moved each parameter by lr * sign(g): the two packages end
    # within a small share of STEPS * lr of each other, except where a
    # gradient was rounding noise and the two stepped opposite ways.
    for name, lr in (("features_dc", 2.5e-3), ("opacity", 0.05), ("scaling", 5e-3)):
        a, b = _np(getattr(tt.model, name)), _np(getattr(jt.model.params, name))
        close = np.abs(a - b) <= 0.02 * STEPS * lr
        assert close.mean() >= 0.9, (name, close.mean())
    out = tt.render_view(tt.cameras[0])
    assert out["render"].grad_fn is None and bool(torch.isfinite(out["render"]).all())


def test_port_trainer_carries_adam_state(trainers):
    """Unlike the JAX Trainer, whose count stays 0 (see the module
    docstring), the port's Trainer keeps what adam_step returns."""
    jt, tt, tc, logs = trainers
    assert int(jt.adam.count) == 0 and float(jnp.abs(jt.adam.mu.xyz).max()) == 0.0
    assert tt.adam.count == 0
    assert tc.adam.count == STEPS and float(tc.adam.mu.xyz.abs().max()) > 0.0
    carried = [m["loss"] for m in logs["port_carrying"]]
    dropped = [m["loss"] for m in logs["port"]]
    assert carried[0] == dropped[0] and carried[1] == dropped[1]  # steps 1 and 2 agree:
    assert carried[2:] != dropped[2:]  # Adam's first step is lr * sign(g) either way
    assert all(np.isfinite(carried))
    for a in (*tc.model.params, *tc.adam.mu, *tc.adam.nu):
        assert bool(torch.isfinite(a).all())


@pytest.mark.parametrize("metrics", [
    {"tile_overflow_frac": 0.25, "tile_count_max": 700.0, "bin_overflow_frac": 0.0,
     "col_overflow_frac": 0.1, "col_count_max": 100.0, "vis_overflow": 1.0},
    {"grad_pack_overflow_frac": 1.0, "grad_pack_max": 9000.0, "bin_overflow_frac": 0.5,
     "bin_count_max": 1e6},
    {"tile_overflow_frac": 0.5},
], ids=["tile_col", "pack_bin_ceiling", "no_demand"])
def test_maybe_grow_caps_matches_jax(trainers, metrics):
    jt, tt, _, _ = trainers
    keep = dict(jt.raster_kwargs), list(jt.cap_growth_events), dict(tt.raster_kwargs), \
        list(tt.cap_growth_events)
    try:
        caps = ("tile_capacity", "bin_capacity", "col_capacity", "grad_pack_capacity")
        assert [tt._current_cap(k) for k in caps] == [jt._current_cap(k) for k in caps]
        jt._maybe_grow_caps(40, metrics)
        tt._maybe_grow_caps(40, {k: torch.tensor(v) for k, v in metrics.items()})
        assert tt.cap_growth_events == jt.cap_growth_events and tt.cap_growth_events
        assert [tt._current_cap(k) for k in caps] == [jt._current_cap(k) for k in caps]
        assert "vis_capacity" not in tt.raster_kwargs
    finally:
        jt.raster_kwargs, jt.cap_growth_events, tt.raster_kwargs, tt.cap_growth_events = keep
        jt._step_fns.clear()


def test_camera_batch_reduces_like_jax(trainers):
    """Two views in one step, as tpu2dgs/train/loop.py:192-202 reduces
    them: the loss and the overflow fractions are means over the views,
    the demand maxima and the radii their maxima, the gradient the mean
    (here: Adam's first moment after one step)."""
    _, tt, _, _ = trainers
    settings = tapi.RasterSettings(W, H, sh_degree=0, bin_capacity=32, tile_capacity=8)
    cams = [tt._cam_arrays[0], tcam.Camera(  # the second view pans the scene off screen
        uid=9, image_name="far", R=tt.cameras[0].R, T=tt.cameras[0].T + np.array([10.0, 0, 0]),
        fovx=tt.cameras[0].fovx, fovy=tt.cameras[0].fovy, width=W, height=H).arrays("cpu")]
    gts = [tt._gt_images[0], tt._gt_images[1]]

    def step(views):
        model = tsplats.grow_capacity(tt.model, tt.model.capacity + 1)  # a private copy
        adam = toptim.init_adam(model.params)
        _, adam, m = tloop.train_step(settings, toptim.OptimConfig(), 0.2, 1.0, model, adam,
                                      [cams[i] for i in views], [gts[i] for i in views],
                                      torch.zeros(3), 1.0, 0.05, 100.0)
        return model, adam, {k: float(v) for k, v in m.items()}

    (m0, a0, near), (m1, a1, far), (mb, ab, both) = step([0]), step([1]), step([0, 1])
    assert near["tile_count_max"] != far["tile_count_max"]
    assert both["tile_count_max"] == max(near["tile_count_max"], far["tile_count_max"])
    assert both["num_visible"] == max(near["num_visible"], far["num_visible"])
    for k in ("loss", "l1", "normal", "dist", "tile_overflow_frac"):
        np.testing.assert_allclose(both[k], 0.5 * (near[k] + far[k]), rtol=1e-6, err_msg=k)
    _close(ab.mu.xyz, 0.5 * (a0.mu.xyz + a1.mu.xyz), 1e-7)
    _close(mb.denom, torch.maximum(m0.denom, m1.denom), 0.0)


def test_trainer_profile_window_writes_a_trace(trainers, tmp_path):
    _, tt, _, _ = trainers
    model = tsplats.grow_capacity(tt.model, tt.model.capacity + 1)
    tr = tloop.Trainer(model, tt.cameras, W, H, 1.0, 3.0, max_sh_degree=0,
                       raster_kwargs=dict(CAPS), profile_dir=str(tmp_path / "prof"),
                       profile_steps=(1, 2))
    tr.train(num_iters=2)
    assert [p.name for p in (tmp_path / "prof").iterdir()] == ["train_steps_1.json"]
    assert tr._profiler is None


def test_trainer_refuses_unported_modes(trainers):
    """The viewer on one device is tests/test_torch_viewer.py's and under a
    mesh tests/test_torch_ranks.py's, where rank 0 alone serves it: rank 0
    given a follower's viewer is refused. A mesh must be the port's
    (tile-row and splat-sharded training are held to one device in
    tests/test_torch_sharded.py and tests/test_torch_splat_sharded.py)."""
    _, tt, _, _ = trainers
    gui = object()
    assert tloop.Trainer(tt.model, tt.cameras, W, H, 1.0, 3.0, gui=gui).gui is gui
    one_rank = Mesh(None, 0, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="rank 0 serves the viewer"):
        tloop.Trainer(tt.model, tt.cameras, W, H, 1.0, 3.0, mesh=one_rank,
                      gui=network_gui.Follower())
    # without a mesh, shard_splats is ignored, as in the JAX package
    tr = tloop.Trainer(tt.model, tt.cameras, W, H, 1.0, 3.0, shard_splats=True)
    assert not tr.shard_splats and tr.model is tt.model and tr.capacity() == tt.model.capacity
    assert tr.whole_state() == (tr.model, tr.adam)
    with pytest.raises(TypeError):
        tloop.Trainer(tt.model, tt.cameras, W, H, 1.0, 3.0, mesh=object())
