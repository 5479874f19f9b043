"""tpu2dgs_torch training state on the command line's side against
tpu2dgs:

  * checkpoints both ways, every array bit-equal under the same keys;
  * gt_cache_mb: host-resident ground truth gives the pre-staged run's
    losses exactly;
  * the Morton KNN: bit-equal to the JAX package's (same source and flags),
    and chosen by create_from_pcd above 65,536 points."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_cli import _npz
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs import native as jnative
from tpu2dgs.model import optim as joptim
from tpu2dgs.model import splats as jsplats
from tpu2dgs.train import checkpoint as jckpt
from tpu2dgs_torch.eval import synthetic
from tpu2dgs_torch.model import optim as toptim
from tpu2dgs_torch.model import splats as tsplats
from tpu2dgs_torch.native import knn as tknn
from tpu2dgs_torch.train import checkpoint as tckpt
from tpu2dgs_torch.train import loop as tloop


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
