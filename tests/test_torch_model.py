"""tpu2dgs_torch model store vs tpu2dgs: PLY files written by either
package load bit-equal in the other, weights carried across with
model.convert render what JAX renders, and an empty model renders pure
background. Also the run's JAX compilation cache (tests/test_torch_threads.py):
the file's compiles go to the run's own directory, and the settings come
back when the cache is left."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache

from tests.test_tiled import _cam, _random_scene, _settings
from tests.test_torch_core import port_cam, to_torch
from tests.test_torch_threads import CACHE_SETTINGS, compile_cache
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.model import splats as jsplats
from tpu2dgs.raster.api import render as jrender
from tpu2dgs_torch.model import convert
from tpu2dgs_torch.model import splats as tsplats
from tpu2dgs_torch.raster import api as tapi

# The cache settings as the session has them before any file's fixture:
# read when the run imports this file to collect it, before any test runs.
SESSION_CACHE = {name: getattr(jax.config, name) for name in CACHE_SETTINGS}


def _jax_model(n=40, capacity=64, seed=5):
    """A JAX SplatModel with random parameters in its first n of capacity rows."""
    xyz, scaling, rotation, opacity, features = _random_scene(n=n, seed=seed)
    m = jsplats.empty_model(capacity, 3)
    p = m.params._replace(
        xyz=m.params.xyz.at[:n].set(xyz),
        features_dc=m.params.features_dc.at[:n].set(features[:, :1]),
        features_rest=m.params.features_rest.at[:n].set(features[:, 1:]),
        scaling=m.params.scaling.at[:n].set(jnp.log(scaling)),
        rotation=m.params.rotation.at[:n].set(rotation),
        opacity=m.params.opacity.at[:n].set(
            jnp.log(opacity / (1.0 - opacity))[:, None]),
    )
    return m._replace(params=p, live=m.live.at[:n].set(True))


def _assert_same_params(tmodel, jmodel):
    for name in jsplats.SplatParams._fields:
        np.testing.assert_array_equal(
            getattr(tmodel, name).detach().numpy(),
            np.asarray(getattr(jmodel.params, name)), err_msg=name)
    np.testing.assert_array_equal(tmodel.live.numpy(), np.asarray(jmodel.live))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_ply_interchange_bit_equal(tmp_path, direction):
    jm = _jax_model()
    path = str(tmp_path / "point_cloud.ply")
    if direction == "jax_to_port":
        jsplats.save_ply(jm, path)
        got = tsplats.load_ply(path, capacity=64, device="cpu")
        _assert_same_params(got, jm)
        assert int(got.num_live()) == int(jm.num_live())
    else:
        params, live = {k: np.asarray(v) for k, v in jm.params._asdict().items()}, \
            np.asarray(jm.live)
        tsplats.save_ply(convert.from_numpy(params, live, device="cpu"), path)
        got = jsplats.load_ply(path, capacity=64)
        for name in jsplats.SplatParams._fields:
            np.testing.assert_array_equal(np.asarray(getattr(got.params, name)),
                                          params[name], err_msg=name)
        np.testing.assert_array_equal(np.asarray(got.live), live)


def test_convert_round_trip_and_render_matches_jax():
    jm = _jax_model()
    params = {k: np.asarray(v) for k, v in jm.params._asdict().items()}
    tm = convert.from_numpy(params, np.asarray(jm.live), device="cpu")
    assert isinstance(tm, torch.nn.Module) and tm.capacity == 64
    back, live = convert.to_numpy(tm)
    for name in params:
        np.testing.assert_array_equal(back[name], params[name], err_msg=name)
    np.testing.assert_array_equal(live, np.asarray(jm.live))

    w, h = 128, 32
    bg = np.array([0.05, 0.1, 0.2], np.float32)
    caps = dict(bin_capacity=128, tile_capacity=128)
    p = jm.params
    out_j = jax.jit(lambda p, live: jrender(
        _cam(w, h), _settings(w, h, "pallas", debug=True, **caps), p.xyz, jnp.exp(p.scaling),
        p.rotation, jax.nn.sigmoid(p.opacity[:, 0]), jsplats.features(p), jnp.asarray(bg),
        live=live))(p, jm.live)
    q = tm.params
    with torch.no_grad():  # serving: render is differentiable, the parameters require grad
        out_t = tapi.render(port_cam(w, h), tapi.RasterSettings(w, h, **caps),
                            q.xyz, torch.exp(q.scaling), q.rotation,
                            torch.sigmoid(q.opacity[:, 0]), tsplats.features(q),
                            to_torch(bg), live=tm.live, device="cpu")
    for k in ["render", "rend_alpha", "surf_depth", "rend_dist"]:
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   rtol=2e-4, atol=2e-4, err_msg=k)
    np.testing.assert_array_equal(out_t["radii"].numpy(), np.asarray(out_j["radii"]))
    assert float(out_t["rend_alpha"].max()) > 0.1


def test_empty_model_renders_background():
    m = tsplats.empty_model(128, device="cpu")
    w, h = 64, 32
    bg = torch.tensor([0.2, 0.4, 0.6])
    p = m.params
    with torch.no_grad():
        out = tapi.render(port_cam(w, h), tapi.RasterSettings(w, h), p.xyz,
                          torch.exp(p.scaling), p.rotation, torch.sigmoid(p.opacity[:, 0]),
                          tsplats.features(p), bg, live=m.live, device="cpu")
    np.testing.assert_array_equal(out["render"].numpy(),
                                  np.broadcast_to(bg.numpy()[:, None, None], (3, h, w)))
    assert float(out["rend_alpha"].abs().max()) == 0.0
    assert all(bool(torch.isfinite(v).all()) for v in out.values()
               if v.dtype.is_floating_point)


def _settings_now():
    return {name: getattr(jax.config, name) for name in CACHE_SETTINGS}


def test_compile_cache_is_the_runs_and_restores(jax_compile_cache, tmp_path_factory, tmp_path):
    """The module's compiles go to the run's own directory (never the
    session's setting; under xdist named by the run's id beside the
    workers' temporary directories, else in the session's), and
    compile_cache, entered from the session's settings, writes there and
    leaves all three settings as it found them, the cache reset."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    assert jax.config.jax_compilation_cache_dir == str(jax_compile_cache)
    assert str(jax_compile_cache) != SESSION_CACHE["jax_compilation_cache_dir"]
    assert jax_compile_cache == (base.parent / f"jax-cache-{run}" if run
                                 else base / "jax-cache")
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0
    before = set(os.listdir(jax_compile_cache))
    jax.jit(lambda x: x * 3.0 + 1.0)(jnp.arange(5.0)).block_until_ready()
    assert set(os.listdir(jax_compile_cache)) > before

    inside = _settings_now()
    for name, value in SESSION_CACHE.items():
        jax.config.update(name, value)
    compilation_cache.reset_cache()
    own = tmp_path / "own"
    own.mkdir()
    try:
        with compile_cache(own):
            jax.jit(lambda x: x - 2.0)(jnp.arange(4.0)).block_until_ready()
            assert os.listdir(own)
        assert _settings_now() == SESSION_CACHE
        written = set(os.listdir(own))
        jax.jit(lambda x: x / 5.0)(jnp.arange(4.0)).block_until_ready()
        assert set(os.listdir(own)) == written  # no cache once it is left
    finally:
        for name, value in inside.items():
            jax.config.update(name, value)
        compilation_cache.reset_cache()
