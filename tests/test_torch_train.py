"""tpu2dgs_torch training modules vs tpu2dgs on the same numpy inputs:
losses, learning rates, Adam, surgery, KNN, create_from_pcd,
grow_capacity, densification statistics, densify_and_prune (the same
split noise handed to both), reset_opacity, the conversion of the whole
training state, and a 5-step Trainer run against the JAX Trainer (Pallas
backend in interpret mode, same seed, same camera order).

The JAX Trainer's step returns the Adam state it was given, not the one
adam_step produced (tpu2dgs/train/loop.py:209-220), so its count stays 0
and every step is Adam's first: lr * sign(g). The port's Trainer carries
the state. The 5-step run is therefore compared with the port's Trainer
made to drop the state the same way, and the port's own run is checked to
carry it; adam_step itself is held against JAX over several steps above.

Tolerances: 1e-6 where the arithmetic is elementwise float32; 1e-5 for
SSIM (sums of 121 products in another order); the training run's loss per
step at rtol 2e-3 (the repo's gradient tolerance is 3e-3, and Adam's first
steps are lr * sign(g))."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_core import to_torch
from tests.test_train import _gt_scene, _orbit_camera
from tpu2dgs.model import densify as jdensify
from tpu2dgs.model import knn as jknn
from tpu2dgs.model import optim as joptim
from tpu2dgs.model import splats as jsplats
from tpu2dgs.train import loop as jloop
from tpu2dgs.train import losses as jlosses
from tpu2dgs_torch.core import cameras as tcam
from tpu2dgs_torch.model import convert
from tpu2dgs_torch.model import densify as tdensify
from tpu2dgs_torch.model import knn as tknn
from tpu2dgs_torch.model import optim as toptim
from tpu2dgs_torch.model import splats as tsplats
from tpu2dgs_torch.parallel.distributed import Mesh
from tpu2dgs_torch.raster import api as tapi
from tpu2dgs_torch.train import loop as tloop
from tpu2dgs_torch.train import losses as tlosses

FIELDS = jsplats.SplatParams._fields


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=1e-6, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol, err_msg=msg)


# -- losses -----------------------------------------------------------------

def _images():
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(3, 37, 52)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    return a, b


LOSSES = {
    "l1": (lambda m, a, b: m.l1_loss(a, b), 1e-6),
    "l2": (lambda m, a, b: m.l2_loss(a, b), 1e-6),
    "ssim": (lambda m, a, b: m.ssim(a, b), 1e-5),
    "photometric": (lambda m, a, b: m.photometric_loss(a, b, 0.2)[0], 1e-5),
    "normal": (lambda m, a, b: m.normal_consistency_loss(a, b), 1e-6),
    "distortion": (lambda m, a, b: m.distortion_loss(a[:1]), 1e-6),
    "psnr": (lambda m, a, b: m.psnr(a, b), 1e-5),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name):
    fn, tol = LOSSES[name]
    a, b = _images()
    _close(fn(tlosses, to_torch(a), to_torch(b)), fn(jlosses, jnp.asarray(a), jnp.asarray(b)),
           tol, name)


def test_ssim_gradient_matches_jax():
    a, b = _images()
    gj = jax.grad(lambda x: jlosses.photometric_loss(x, jnp.asarray(b), 0.2)[0])(jnp.asarray(a))
    x = to_torch(a).requires_grad_()
    gt, = torch.autograd.grad(tlosses.photometric_loss(x, to_torch(b), 0.2)[0], x)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-8)


# -- optimizer --------------------------------------------------------------

@pytest.mark.parametrize("step", [0.0, 1.0, 150.0, 7000.0, 30000.0, 50000.0])
def test_learning_rates_match_jax(step):
    cfg = dict(position_lr_init=2e-4, position_lr_delay_mult=0.02, feature_lr=3e-3)
    lj = joptim.learning_rates(joptim.OptimConfig(**cfg), jnp.float32(step), 2.5)
    lt = toptim.learning_rates(toptim.OptimConfig(**cfg), step, 2.5)
    for name in FIELDS:
        _close(getattr(lt, name), getattr(lj, name), 1e-6, name)
    _close(toptim.expon_lr(step, 1e-2, 1e-4, lr_delay_steps=100, lr_delay_mult=0.1,
                           max_steps=30000),
           joptim.expon_lr(jnp.float32(step), 1e-2, 1e-4, lr_delay_steps=100,
                           lr_delay_mult=0.1, max_steps=30000), 1e-6)


def _random_params(rng, c=48):
    return {"xyz": rng.normal(size=(c, 3)), "features_dc": rng.normal(size=(c, 1, 3)),
            "features_rest": rng.normal(size=(c, 15, 3)),
            "scaling": rng.uniform(-3.0, -1.0, (c, 2)), "rotation": rng.normal(size=(c, 4)),
            "opacity": rng.normal(size=(c, 1))}


def _both_params(d):
    d = {k: np.asarray(v, np.float32) for k, v in d.items()}
    return (jsplats.SplatParams(**{k: jnp.asarray(v) for k, v in d.items()}),
            tsplats.SplatParams(**{k: to_torch(v) for k, v in d.items()}))


def test_adam_step_and_surgery_match_jax():
    rng = np.random.default_rng(1)
    pj, pt = _both_params(_random_params(rng))
    live = rng.uniform(size=48) < 0.8
    aj, at = joptim.init_adam(pj), toptim.init_adam(pt)
    cfg_j, cfg_t = joptim.OptimConfig(), toptim.OptimConfig()
    for step in (1.0, 2.0, 3.0):
        # gradients over many magnitudes, some exactly zero
        g = {k: v * 10.0 ** rng.uniform(-8, 0, v.shape) * (rng.uniform(size=v.shape) < 0.9)
             for k, v in _random_params(rng).items()}
        gj, gt = _both_params(g)
        pj, aj = joptim.adam_step(cfg_j, pj, gj, aj, joptim.learning_rates(
            cfg_j, jnp.float32(step), 1.5), jnp.asarray(live))
        pt, at = toptim.adam_step(cfg_t, pt, gt, at, toptim.learning_rates(cfg_t, step, 1.5),
                                  to_torch(live))
        if step == 2.0:
            rows = rng.uniform(size=48) < 0.3
            aj, at = joptim.surgery(aj, jnp.asarray(rows)), toptim.surgery(at, to_torch(rows))
            assert float(at.mu.xyz[to_torch(rows)].abs().max()) == 0.0
    assert at.count == int(aj.count) == 3
    for name in FIELDS:
        _close(getattr(pt, name), getattr(pj, name), 1e-6, f"param {name}")
        _close(getattr(at.mu, name), getattr(aj.mu, name), 1e-6, f"mu {name}")
        np.testing.assert_allclose(_np(getattr(at.nu, name)), _np(getattr(aj.nu, name)),
                                   rtol=1e-6, atol=1e-12, err_msg=f"nu {name}")


# -- model ------------------------------------------------------------------

@pytest.mark.parametrize("n", [5, 700, 2500])
def test_knn_matches_jax(n):
    pts = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    got = tknn.mean_dist2_to_3nn(to_torch(pts), row_block=512, col_chunk=1024)
    _close(got, jknn.mean_dist2_to_3nn(jnp.asarray(pts)), 1e-6)


def _assert_same_model(tm, jm, tol=1e-6):
    for name in FIELDS:
        _close(getattr(tm, name), getattr(jm.params, name), tol, name)
    np.testing.assert_array_equal(_np(tm.live), _np(jm.live))
    for name in tsplats.STATS:
        _close(getattr(tm, name), getattr(jm, name), tol, name)


def _pcd(n=40, seed=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)).astype(np.float32), rng.uniform(size=(n, 3)).astype(np.float32)


def test_create_from_pcd_and_grow_capacity_match_jax():
    pts, rgb = _pcd()
    jm = jsplats.create_from_pcd(pts, rgb, capacity=64)
    tm = tsplats.create_from_pcd(pts, rgb, capacity=64, device="cpu")
    _assert_same_model(tm, jm)
    assert tsplats.create_from_pcd(pts, rgb, device="cpu").capacity == 4096
    jm = jm._replace(grad_accum=jm.grad_accum.at[:40].set(0.5), denom=jm.denom + 2.0)
    tm.grad_accum[:40] = 0.5
    tm.denom += 2.0
    tg = tsplats.grow_capacity(tm, 96)
    _assert_same_model(tg, jsplats.grow_capacity(jm, 96))
    assert tg.capacity == 96 and tsplats.grow_capacity(tm, 64) is tm
    # two segments: each keeps its rows and gains half the new ones
    _assert_same_model(tsplats.grow_capacity(tm, 128, segments=2),
                       jsplats.grow_capacity(jm, 128, segments=2))


def _stats_pair(seed=3, n=40, c=64):
    """Both packages' models with the same accumulated statistics."""
    pts, rgb = _pcd(n, seed)
    rng = np.random.default_rng(seed)
    jm = jsplats.create_from_pcd(pts, rgb, capacity=c)
    tm = tsplats.create_from_pcd(pts, rgb, capacity=c, device="cpu")
    for _ in range(3):
        g = (rng.normal(size=(c, 2)) * 4e-4).astype(np.float32)
        radii = rng.integers(0, 30, c).astype(np.int32) * (rng.uniform(size=c) < 0.7)
        jm = jdensify.add_stats(jm, jnp.asarray(g), jnp.asarray(radii))
        tm = tdensify.add_stats(tm, to_torch(g), to_torch(radii))
    return tm, jm


def test_add_stats_matches_jax():
    tm, jm = _stats_pair()
    _assert_same_model(tm, jm)
    assert float(tm.denom.max()) == 3.0 and float(tm.max_radii2d.max()) > 0.0


@pytest.mark.parametrize("case", ["room", "full", "size_prune"])
def test_densify_and_prune_matches_jax(case):
    c = 128  # one shape: the JAX function compiles once for the three cases
    tm, jm = _stats_pair(seed=4, n=120 if case == "full" else 40, c=c)
    # a spread of scales around percent_dense * extent, some low opacities
    rng = np.random.default_rng(5)
    scaling = rng.uniform(-4.5, -2.0, (c, 2)).astype(np.float32)
    opacity = rng.uniform(-4.0, 3.0, (c, 1)).astype(np.float32)
    jm = jm._replace(params=jm.params._replace(scaling=jnp.asarray(scaling),
                                              opacity=jnp.asarray(opacity)))
    with torch.no_grad():
        tm.scaling.copy_(to_torch(scaling))
        tm.opacity.copy_(to_torch(opacity))
    aj, at = joptim.init_adam(jm.params), toptim.init_adam(tm.params)
    aj = aj._replace(mu=jax.tree.map(lambda a: a + 1.0, aj.mu),
                     nu=jax.tree.map(lambda a: a + 2.0, aj.nu))
    for a in at.mu:
        a += 1.0
    for a in at.nu:
        a += 2.0
    key = jax.random.PRNGKey(9)
    eps = np.asarray(jax.random.normal(key, (2, c, 2), jnp.float32))
    use_size = case == "size_prune"
    # the port changes the moments in place: a copy for the segmented round
    at_seg = toptim.AdamState(at.count, *(tsplats.SplatParams(*(a.clone() for a in m))
                                          for m in (at.mu, at.nu)))
    jm2, aj2, ij = jdensify.densify_and_prune(jdensify.DensifyConfig(), jm, aj, key, 3.0, use_size)
    tm2, at2, it = tdensify.densify_and_prune(tdensify.DensifyConfig(), tm, at, None, 3.0,
                                              use_size, eps=to_torch(eps))
    for k in ij._fields:
        assert int(getattr(it, k)) == int(getattr(ij, k)), k
    assert int(it.num_cloned) > 0 and int(it.num_split) > 0 and int(it.num_pruned) > 0
    assert (int(it.num_dropped) > 0) == (case == "full")
    _assert_same_model(tm2, jm2)
    for name in FIELDS:
        np.testing.assert_array_equal(_np(getattr(at2.mu, name)), _np(getattr(aj2.mu, name)))
        np.testing.assert_array_equal(_np(getattr(at2.nu, name)), _np(getattr(aj2.nu, name)))
    # two segments, each compacting its children into its own free slots
    jm3, aj3, ij3 = jdensify.densify_and_prune(jdensify.DensifyConfig(), jm, aj, key, 3.0,
                                               use_size, segments=2)
    tm3, at3, it3 = tdensify.densify_and_prune(tdensify.DensifyConfig(), tm, at_seg, None,
                                               3.0, use_size, segments=2, eps=to_torch(eps))
    for k in ij3._fields:
        assert int(getattr(it3, k)) == int(getattr(ij3, k)), k
    _assert_same_model(tm3, jm3)
    for name in FIELDS:
        np.testing.assert_array_equal(_np(getattr(at3.mu, name)), _np(getattr(aj3.mu, name)))
        np.testing.assert_array_equal(_np(getattr(at3.nu, name)), _np(getattr(aj3.nu, name)))
    # drawing the noise from a generator is reproducible from its seed
    runs = [tdensify.densify_and_prune(tdensify.DensifyConfig(), tm, at,
                                       torch.Generator().manual_seed(1), 3.0, False)[0]
            for _ in range(2)]
    assert torch.equal(runs[0].xyz, runs[1].xyz)


def test_reset_opacity_matches_jax():
    tm, jm = _stats_pair(seed=6)
    aj, at = joptim.init_adam(jm.params), toptim.init_adam(tm.params)
    aj = aj._replace(mu=jax.tree.map(lambda a: a + 1.0, aj.mu))
    for a in at.mu:
        a += 1.0
    jm2, aj2 = jdensify.reset_opacity(jm, aj)
    tm2, at2 = tdensify.reset_opacity(tm, at)
    _assert_same_model(tm2, jm2)
    assert float(at2.mu.opacity.abs().max()) == 0.0 and float(at2.mu.xyz.min()) == 1.0
    np.testing.assert_array_equal(_np(at2.mu.opacity), _np(aj2.mu.opacity))


def test_convert_carries_training_state():
    tm, jm = _stats_pair(seed=7)
    rng = np.random.default_rng(7)
    aj = joptim.AdamState(
        count=jnp.int32(17),
        mu=jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32), jm.params),
        nu=jax.tree.map(lambda a: jnp.asarray(rng.uniform(size=a.shape), jnp.float32), jm.params))
    state = {
        "params": {k: np.asarray(v) for k, v in jm.params._asdict().items()},
        "live": np.asarray(jm.live),
        "stats": {k: np.asarray(getattr(jm, k)) for k in tsplats.STATS},
        "adam": {"count": int(aj.count),
                 "mu": {k: np.asarray(v) for k, v in aj.mu._asdict().items()},
                 "nu": {k: np.asarray(v) for k, v in aj.nu._asdict().items()}},
    }
    model, adam = convert.state_from_numpy(state, device="cpu")
    _assert_same_model(model, jm, tol=0.0)
    assert adam.count == 17
    back = convert.state_to_numpy(model, adam)

    def flat(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield prefix + k, v

    want, got = dict(flat(state)), dict(flat(back))
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # back into the JAX package: the arrays are its leaves
    jm_back = jsplats.SplatModel(params=jsplats.SplatParams(**back["params"]), live=back["live"],
                                 **back["stats"])
    assert int(jm_back.num_live()) == int(jm.num_live())


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
    """The viewer is ported for one device (tests/test_torch_viewer.py) and
    not under a mesh; a mesh must be the port's (tile-row and
    splat-sharded training are held to one device in
    tests/test_torch_sharded.py and tests/test_torch_splat_sharded.py)."""
    _, tt, _, _ = trainers
    gui = object()
    assert tloop.Trainer(tt.model, tt.cameras, W, H, 1.0, 3.0, gui=gui).gui is gui
    one_rank = Mesh(None, 0, 1, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="viewer under a mesh is a later slice"):
        tloop.Trainer(tt.model, tt.cameras, W, H, 1.0, 3.0, mesh=one_rank, gui=gui)
    # without a mesh, shard_splats is ignored, as in the JAX package
    tr = tloop.Trainer(tt.model, tt.cameras, W, H, 1.0, 3.0, shard_splats=True)
    assert not tr.shard_splats and tr.model is tt.model and tr.capacity() == tt.model.capacity
    assert tr.whole_state() == (tr.model, tr.adam)
    with pytest.raises(TypeError):
        tloop.Trainer(tt.model, tt.cameras, W, H, 1.0, 3.0, mesh=object())
