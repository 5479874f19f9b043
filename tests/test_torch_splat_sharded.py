"""Splat-sharded rendering and training of the port ("gaussian
parallelism"): two gloo ranks on the CPU (parallel.distributed.spawn; the
ranks run functions of parallel/rehearsal.py), each holding its own half
of the splat rows, against the JAX package's render(mesh=make_mesh(2),
shard_splats=True) on the conftest's virtual devices and against the port
on one device.

  * the render keys within 2e-4 of JAX's, radii and demand counters
    equal, gradients at tests/test_sharded.py's rtol 2e-3 / atol 3e-4
    (where float32 cannot hold that, nearer a float64 gradient), for
    work windows with the all-gather exchange and static strips with the
    routed one (the overflow fractions are not compared in work mode, as
    tests/test_torch_sharded.py says why);
  * the routed exchange against the all-gather one inside the port, and a
    routed render whose messages overflow, its counters against a count
    of the boxes in numpy;
  * densify_and_prune(segments=S), grow_capacity(segments=S) and
    grow_with_adam(segments=S) against JAX's, and each segment's round
    alone against its segment of the segmented round;
  * a two-rank Trainer(shard_splats=True) against the port's one-device
    Trainer, then through densification and growth with every rank's
    tensors at half the capacity;
  * cli.train --n_devices 2 --shard_mode splats, and a resume from its
    checkpoint, in the same two ranks, with no whole model referenced on
    any rank between the writes.

The scene has splats at the same positions on both ranks, so depths tie
across them: the merge must put rank 0's first, as one device's (depth,
id) order does. PyTorch runs on one thread (`one_torch_thread`), and so
does each rank.
"""

import json
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
from tests.test_torch_sharded import _camera, _orbit
from tpu2dgs.core import cameras as jcam
from tpu2dgs.model import densify as jdensify
from tpu2dgs.model import optim as joptim
from tpu2dgs.model import splats as jsplats
from tpu2dgs.parallel.sharded import make_mesh
from tpu2dgs.raster.api import render as jrender
from tpu2dgs.train import loop as jloop
from tpu2dgs_torch.core import cameras as tcam
from tpu2dgs_torch.core import sh as tsh
from tpu2dgs_torch.model import densify as tdensify
from tpu2dgs_torch.model import optim as toptim
from tpu2dgs_torch.model import splats as tsplats
from tpu2dgs_torch.parallel import distributed, rehearsal, sharded
from tpu2dgs_torch.raster import api as tapi
from tpu2dgs_torch.raster import preprocess as tpre
from tpu2dgs_torch.train import checkpoint as tckpt
from tpu2dgs_torch.train import loop as tloop

W, H = 150, 160  # 2 x 10 tiles of 16 x 128: the windows split inside a coarse-bin row
BG = np.array([0.2, 0.1, 0.0], np.float32)
# tests/test_torch_sharded.py's scene and capacities, for the JAX package
N, CAPS = 150, dict(bin_capacity=256, tile_capacity=128)
# name: (row_balance, xfer_capacity); the first two are held against JAX
SETTINGS = {"work": ("work", 0), "static routed": ("static", 128),
            "work routed": ("work", 128), "static": ("static", 0)}
JAX_CASES = ("work", "static routed")
# The keys tests/test_sharded.py holds JAX's splat-sharded render to: not
# surf_normal, the finite differences of surf_depth.
JAX_KEYS = ("render", "rend_alpha", "rend_normal", "depth_median", "rend_dist", "surf_depth")
# Gradients against JAX's at tests/test_sharded.py's rtol 2e-3 / atol
# 3e-4, elementwise, but for elements that are ill-conditioned in float32:
# where JAX's float32 gradient is itself outside that tolerance of the
# float64 gradient (the port's oracle backend in float64), the port's must
# be at least as near the float64 one. On this scene those are the xyz
# gradients of two splats (4 of 450 elements); the sums of per-pixel terms
# that make them cancel, so both packages' float32 rounding moves them by
# more than the tolerance, JAX's the more.
GRAD_RTOL, GRAD_ATOL = 2e-3, 3e-4
COUNTERS = {"work": ("tile_count_max", "bin_count_max", "col_count_max", "grad_pack_max",
                     "strip_work"),
            "static routed": ("tile_count_max", "bin_count_max", "col_count_max",
                              "grad_pack_max", "strip_work", "tile_overflow_frac",
                              "bin_overflow_frac", "xfer_count_max", "xfer_overflow_frac")}
# A second scene, held to the port's one-device render: 200 splats a rank
# (k_loc = 200 > 128, so a routed message can overflow), no list
# overflowing, and 40 of rank 1's splats at the depths of 40 of rank 0's,
# so depths tie across the ranks and the merge must put rank 0's first, as
# one device's (depth, id) order does.
N_TIES, CAPS_TIES = 400, dict(bin_capacity=512, tile_capacity=256)
TIES = {"ties work": ("work", 0), "ties static": ("static", 0),
        "ties overflow": ("static", 128)}
CPU = torch.device("cpu")


def _ties_scene():
    scene = [np.array(a) for a in _random_scene(n=N_TIES, seed=3)]
    scene[0][N_TIES // 2:N_TIES // 2 + 40, 2] = scene[0][:40, 2]  # view depth is z here
    return scene


def _jax_loss_and_out(jset, jcamera, mesh):
    def loss(*params):
        out = jrender(jcamera, jset, *params, jnp.asarray(BG), mesh=mesh, shard_splats=True)
        return (jnp.sum(out["render"] ** 2) + jnp.sum(out["rend_dist"])
                + 0.1 * jnp.sum(out["rend_normal"] * out["surf_normal"])), out
    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True))


@pytest.fixture(scope="module")
def renders():
    """Both scenes through two gloo ranks (every setting in one run, each
    rank from its own rows, and in the same run the two splat-sharded
    Trainer runs of `_training`) and through the port on one device, the first
    through JAX on a two-device mesh (one program for the forward and the
    gradients of each compared setting), and the port's preprocess of the
    second on one device (for its boxes)."""
    scene = [np.asarray(a) for a in _random_scene(n=N, seed=3)]
    ties = _ties_scene()
    cam = tcam.Camera(**_camera())

    def settings(caps, table):
        return [tapi.RasterSettings(W, H, **caps, row_balance=rb, xfer_capacity=x)
                for rb, x in table.values()]

    model, cams, w, h, steady, growing = _training()
    ranks = distributed.spawn(
        rehearsal.each, 2,
        args=([(rehearsal.render_rank, (cam, settings(CAPS, SETTINGS), scene, BG, True, True)),
               (rehearsal.render_rank, (cam, settings(CAPS_TIES, TIES), ties, BG, True,
                                        True)),
               (rehearsal.train_rank, (model, cams, w, h, (10,),
                                       dict(steady, shard_splats=True))),
               (rehearsal.train_rank, (model, cams, w, h, (2, 9, 13),
                                       dict(growing, shard_splats=True)))],),
        device="cpu", timeout_s=600)
    one = {"scene": rehearsal.render_once(cam, tapi.RasterSettings(W, H, **CAPS), scene, BG,
                                          CPU, plain=True),
           "ties": rehearsal.render_once(cam, tapi.RasterSettings(W, H, **CAPS_TIES), ties,
                                         BG, CPU, plain=True)}
    jcamera = jcam.Camera(**_camera()).arrays()
    mesh = make_mesh(2)
    jax_out = {}
    for name in JAX_CASES:
        rb, x = SETTINGS[name]
        jset = _settings(W, H, "pallas", debug=True, **CAPS, row_balance=rb, xfer_capacity=x)
        (_, out), grads = _jax_loss_and_out(jset, jcamera, mesh)(*scene)
        jax_out[name] = {k: np.asarray(v) for k, v in out.items()}
        jax_out[name].update({f"grad_{p}": np.asarray(g)
                              for p, g in zip(rehearsal.PARAMS, grads)})
    with torch.no_grad():
        t = [torch.from_numpy(a) for a in ties]
        pre = tpre.preprocess(t[0], t[1], t[2], t[3], t[4], cam.arrays(CPU), W, H, 3)
    by_name = {name: [r[0][i] for r in ranks] for i, name in enumerate(SETTINGS)}
    by_name.update({name: [r[1][i] for r in ranks] for i, name in enumerate(TIES)})
    return {"ranks": by_name, "jax": jax_out, "one": one, "preprocessed": pre,
            "float64": _float64_gradients(cam, scene),
            "trained": [r[2:] for r in ranks]}


def _float64_gradients(cam, scene):
    """The gradients of `rehearsal.loss_of` through the port's oracle
    backend (per-pixel, no lists) in float64: what both packages' float32
    gradients are measured against."""
    f64 = torch.float64
    arrays = cam.arrays(CPU)
    arrays = type(arrays)(*(a.to(f64) if torch.is_tensor(a) and a.is_floating_point() else a
                            for a in arrays))
    params = [torch.tensor(a, dtype=f64, requires_grad=True) for a in scene]
    out = tapi.render(arrays, tapi.RasterSettings(W, H, backend="oracle"), *params,
                      torch.tensor(BG, dtype=f64), device=CPU)
    grads = torch.autograd.grad(rehearsal.loss_of(out), params)
    return {p: g.numpy() for p, g in zip(rehearsal.PARAMS, grads)}


def _whole(got, key):
    """The ranks' rows of a per-splat output, concatenated in rank order."""
    return np.concatenate([g[key] for g in got])


def _held_to_one(got, one):
    """Two ranks' sharded render against one device's: both ranks' maps
    bit-equal, every render key within 2e-4, radii equal, gradients at
    tests/test_sharded.py's rtol 2e-3 / atol 3e-4."""
    for k, v in got[0].items():
        if k not in ("launches", "seconds", "radii", "mean2d", "visibility_filter") \
                and not k.startswith("grad_"):
            np.testing.assert_array_equal(got[1][k], v, err_msg=f"ranks differ: {k}")
    for k in rehearsal.KEYS:
        np.testing.assert_allclose(got[0][k], one[k], rtol=2e-4, atol=2e-4,
                                   err_msg=f"one device: {k}")
    np.testing.assert_array_equal(_whole(got, "radii"), one["radii"])
    assert float(got[0]["vis_overflow"]) == 0.0
    for p in rehearsal.PARAMS:
        g = _whole(got, f"grad_{p}")
        assert float(np.abs(g).max()) > 0.0, p
        np.testing.assert_allclose(g, one[f"grad_{p}"], rtol=2e-3, atol=3e-4,
                                   err_msg=f"one device: {p}")


@pytest.mark.parametrize("name", JAX_CASES)
def test_splat_sharded_render_matches_jax(renders, name):
    got, want = renders["ranks"][name], renders["jax"][name]
    _held_to_one(got, renders["one"]["scene"])
    for k in JAX_KEYS:
        np.testing.assert_allclose(got[0][k], want[k], rtol=2e-4, atol=2e-4, err_msg=k)
    np.testing.assert_array_equal(_whole(got, "radii"), want["radii"])
    for k in COUNTERS[name]:
        np.testing.assert_array_equal(got[0][k], want[k], err_msg=k)
    for p in rehearsal.PARAMS:
        g, jg, exact = _whole(got, f"grad_{p}"), want[f"grad_{p}"], renders["float64"][p]
        ill = np.abs(jg - exact) > GRAD_ATOL + GRAD_RTOL * np.abs(exact)
        near = np.abs(g - jg) <= GRAD_ATOL + GRAD_RTOL * np.abs(jg)
        nearer = np.abs(g - exact) <= np.abs(jg - exact)
        assert (near | (ill & nearer)).all(), (p, np.argwhere(~near).tolist())
        assert ill.sum() <= 4, (p, np.argwhere(ill).tolist())
    if name == "work":  # each rank's buffers shorter than the image, both windows at work
        assert (got[0]["strip_rows"] < H).all() and got[0]["strip_work"].min() > 0


def test_routed_exchange_depth_ties_and_overflow(renders):
    ranks = renders["ranks"]
    for routed, gathered in ((ranks["work routed"], ranks["work"]),
                             (ranks["static routed"], ranks["static"])):
        assert float(routed[0]["xfer_overflow_frac"]) == 0.0
        for k in (*rehearsal.KEYS, "radii"):
            np.testing.assert_allclose(routed[0][k], gathered[0][k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        for p in rehearsal.PARAMS:
            np.testing.assert_allclose(_whole(routed, f"grad_{p}"), _whole(gathered, f"grad_{p}"),
                                       rtol=1e-5, atol=1e-6, err_msg=p)
    for name in ("ties work", "ties static"):
        _held_to_one(ranks[name], renders["one"]["ties"])
    # The overflowing render: each rank's demand on each static strip, from
    # the boxes as compact_visible rounds them (every visible splat of a
    # rank survives: k_loc = 200 rows).
    pre = renders["preprocessed"]
    c, e = pre.box_center.numpy(), pre.box_half.numpy()
    y0, y1 = np.ceil(c[:, 1] - e[:, 1]), np.floor(c[:, 1] + e[:, 1])
    vis = pre.visible.numpy()
    rows_per = 8 * 16  # two static strips: tile rows 0-7 and 8-9
    demand = np.array([[np.sum(vis[r] & (y0[r] <= min(lo + rows_per, H) - 1) & (y1[r] >= lo))
                        for lo in (0, rows_per)]
                       for r in (slice(0, N_TIES // 2), slice(N_TIES // 2, N_TIES))])
    got = ranks["ties overflow"][0]
    np.testing.assert_array_equal(got["radii"], ranks["ties static"][0]["radii"])
    assert demand.max() > 128
    assert float(got["xfer_count_max"]) == float(demand.max())
    assert float(got["xfer_overflow_frac"]) == float(np.max(np.mean(demand > 128, axis=1)))
    assert got["xfer_overflow_frac"] > 0.0


def _state_pair(c=128, segments=4, seed=8):
    """Both packages' models and Adam states from the same arrays: segment
    0 whole, segment 1 half, segment 2 nearly empty, segment 3 empty of
    live splats; scales around percent_dense * extent, some low opacities,
    every live splat hot."""
    rng = np.random.default_rng(seed)
    ell = c // segments
    live = np.zeros(c, bool)
    live[:ell] = True
    live[ell:ell + ell // 2] = True
    live[2 * ell:2 * ell + 3] = True
    arrays = {
        "xyz": rng.normal(size=(c, 3)), "features_dc": rng.normal(size=(c, 1, 3)),
        "features_rest": rng.normal(size=(c, 15, 3)) * 0.1,
        "scaling": rng.uniform(-4.5, -2.0, (c, 2)), "rotation": rng.normal(size=(c, 4)),
        "opacity": rng.uniform(-4.0, 3.0, (c, 1))}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    stats = {"max_radii2d": rng.integers(0, 30, c).astype(np.float32),
             "grad_accum": np.where(live, 1.0, 0.0).astype(np.float32),
             "denom": live.astype(np.float32)}
    jp = jsplats.SplatParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jm = jsplats.SplatModel(params=jp, live=jnp.asarray(live),
                            **{k: jnp.asarray(v) for k, v in stats.items()})
    tm = tsplats.SplatModel(tsplats.SplatParams(**{k: torch.from_numpy(v.copy())
                                                   for k, v in arrays.items()}),
                            torch.from_numpy(live.copy()),
                            **{k: torch.from_numpy(v.copy()) for k, v in stats.items()})
    aj = joptim.init_adam(jp)
    aj = aj._replace(mu=jax.tree.map(lambda a: a + 1.0, aj.mu),
                     nu=jax.tree.map(lambda a: a + 2.0, aj.nu))
    at = toptim.init_adam(tm.params)
    for a in at.mu:
        a += 1.0
    for a in at.nu:
        a += 2.0
    return tm, at, jm, aj


def _same(t, j, name, exact=False):
    a, b = t.detach().numpy(), np.asarray(j)
    if exact or a.dtype == bool:
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=name)


def test_segmented_densify_and_growth_match_jax():
    s, c = 4, 128
    ell = c // s
    cfg = tdensify.DensifyConfig(grad_threshold=1e-6)
    key = jax.random.PRNGKey(11)
    eps = np.array(jax.random.normal(key, (2, c, 2), jnp.float32))
    tm, at, jm, aj = _state_pair(c, s)
    jm2, aj2, ij = jdensify.densify_and_prune(jdensify.DensifyConfig(grad_threshold=1e-6),
                                              jm, aj, key, 3.0, False, segments=s)
    tm2, at2, it = tdensify.densify_and_prune(cfg, tm, at, None, 3.0, False, segments=s,
                                              eps=torch.from_numpy(eps))
    for k in ij._fields:
        assert int(getattr(it, k)) == int(getattr(ij, k)), k
    assert int(it.num_dropped) > 0 and int(it.num_split) > 0  # segment 0 is full
    for name in tsplats.SplatParams._fields:
        _same(getattr(tm2, name), getattr(jm2.params, name), name)
        _same(getattr(at2.mu, name), getattr(aj2.mu, name), "mu." + name, exact=True)
        _same(getattr(at2.nu, name), getattr(aj2.nu, name), "nu." + name, exact=True)
    _same(tm2.live, jm2.live, "live")
    # each segment's round alone is its segment of the segmented round
    tm, at, _, _ = _state_pair(c, s)
    for d in range(s):
        sl = slice(d * ell, (d + 1) * ell)
        part = tsplats.SplatModel(tsplats.SplatParams(*(a.detach()[sl].clone()
                                                        for a in tm.params)),
                                  tm.live[sl].clone(),
                                  *(getattr(tm, k)[sl].clone() for k in tsplats.STATS))
        pa = toptim.AdamState(at.count, tsplats.SplatParams(*(a[sl].clone() for a in at.mu)),
                              tsplats.SplatParams(*(a[sl].clone() for a in at.nu)))
        m, a, _ = tdensify.densify_and_prune(cfg, part, pa, None, 3.0, False,
                                             eps=torch.from_numpy(eps[:, sl]))
        assert torch.equal(m.live, tm2.live[sl]), d
        for x, y in zip([*m.params, *a.mu, *a.nu], [*tm2.params, *at2.mu, *at2.nu]):
            assert torch.equal(x.detach(), y.detach()[sl]), d
    # growth spreads the new rows over the segments, as JAX's
    jg = jsplats.grow_capacity(jm2, 2 * c, segments=s)
    tg = tsplats.grow_capacity(tm2, 2 * c, segments=s)
    for name in tsplats.SplatParams._fields:
        _same(getattr(tg, name), getattr(jg.params, name), name)
    for name in ("live", *tsplats.STATS):
        _same(getattr(tg, name), getattr(jg, name), name, exact=True)
    # each segment keeps its rows first and gains its dead rows at its end
    assert torch.equal(tg.live.reshape(s, 2 * ell)[:, :ell], tm2.live.reshape(s, ell))
    assert not bool(tg.live.reshape(s, 2 * ell)[:, ell:].any())
    tg, tga = tloop.grow_with_adam(tm2, at2, 2 * c, segments=s)
    jg, jga = jloop.grow_with_adam(jm2, aj2, 2 * c, segments=s)
    for name in tsplats.SplatParams._fields:
        _same(getattr(tga.mu, name), getattr(jga.mu, name), "mu." + name, exact=True)
        _same(getattr(tga.nu, name), getattr(jga.nu, name), "nu." + name, exact=True)
    with pytest.raises(ValueError, match="equal segments"):
        tsplats.grow_capacity(tm2, 2 * c + 2, segments=s)


def _training():
    """The Trainer runs' inputs: a 16-splat ground truth rendered from six
    orbit views at 64x128, a start model of capacity 64 (rank 1's segment
    holds no live splat), and tests/test_multichip_train.py's two runs: 10
    steps without densification, then densification rounds and growth over
    batches of two views."""
    w, h = 64, 128
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
    caps = dict(bin_capacity=256, tile_capacity=128)
    settings = tapi.RasterSettings(w, h, sh_degree=0, **caps)
    with torch.no_grad():
        for c in cams:
            c.image = tapi.render(c.arrays(CPU), settings, *gt, torch.zeros(3),
                                  device=CPU)["render"].numpy()
    start = gt[0].numpy() + np.random.default_rng(3).normal(scale=0.04, size=(n, 3))
    model = rehearsal.model_arrays(tsplats.create_from_pcd(start.astype(np.float32), rgb,
                                                           capacity=64, device=CPU))
    steady = dict(spatial_lr_scale=1.0, scene_extent=3.0, max_sh_degree=0, seed=1,
                  raster_kwargs=dict(caps),
                  train_cfg=tloop.TrainConfig(densify_from_iter=10_000,
                                              opacity_reset_interval=10_000,
                                              normal_from_iter=5, dist_from_iter=10_000,
                                              lambda_normal=0.01))
    growing = dict(steady, max_capacity=4096, raster_kwargs=dict(caps, xfer_capacity=128),
                   train_cfg=tloop.TrainConfig(densify_from_iter=3, densify_until_iter=100,
                                               densification_interval=4, grad_threshold=0.0,
                                               opacity_reset_interval=10_000,
                                               normal_from_iter=10_000,
                                               dist_from_iter=10_000, grow_watermark=0.3,
                                               camera_batch=2))
    return model, cams, w, h, steady, growing


def test_splat_sharded_trainer_matches_one_device_and_stays_sharded(renders):
    model, cams, w, h, steady, _ = _training()
    one = rehearsal.train_once(model, cams, w, h, (10,), steady, CPU)
    (same0, grown0), (same1, grown1) = renders["trained"]
    assert same0["loss"] == same1["loss"]
    np.testing.assert_allclose(same0["loss"], one["loss"], rtol=2e-3, atol=1e-7)
    for k in ("xyz", "opacity"):
        np.testing.assert_allclose(same0["stops"][0]["params"][k],
                                   one["stops"][0]["params"][k], atol=5e-5, err_msg=k)
    assert same0["stops"][0]["rows"] == same1["stops"][0]["rows"] == [32]
    assert "params" not in same1["stops"][0]  # rank 0 alone holds the gathered model
    for r in (grown0, grown1):
        for stop in r["stops"]:
            assert stop["rows"] == [stop["capacity"] // 2], stop["rows"]
        assert len(r["rounds"]) == 3
    for rnd in grown0["rounds"]:
        assert rnd["live_equal"] and rnd["adam_equal"] and rnd["params_rel_err"] <= 1e-6
    first, _, last = grown0["stops"]
    assert last["capacity"] > first["capacity"] == 64 and last["num_live"] > 16
    assert grown0["rounds"][0]["rank_info"][4] > 0 == grown1["rounds"][0]["rank_info"][4]


def test_cli_train_splat_sharded_writes_whole_model_and_resumes(tmp_path):
    root = str(tmp_path / "scene")
    os.makedirs(root)
    _make_colmap_dataset(root, n_views=6, n_pts=40)  # 64x48, the JAX package's writers
    out, resumed = str(tmp_path / "two"), str(tmp_path / "resumed")
    splats = ["--n_devices", "2", "--shard_mode", "splats", *TRAIN_FLAGS]
    # both runs in the same two ranks: a checkpoint at 3 and one at 6 (with
    # the PLY and the test report), then a resume from 6 to 9
    runs = distributed.spawn(rehearsal.cli_rank, 2, args=([
        ["-s", root, "-m", out, *splats, "--checkpoint_iterations", "3", "6"],
        ["-s", root, "-m", resumed, *splats, "--iterations", "9", "--save_iterations", "9",
         "--test_iterations", "9", "--start_checkpoint", os.path.join(out, "chkpnt6.npz")],
    ],), device="cpu", timeout_s=600)
    for rank in runs:  # no whole model referenced before a block of steps or after a run
        assert [[x["step"] for x in run] for run in rank] == [[0, 3, 6], [6, 9]]
        for x in (x for run in rank for x in run):
            assert x["capacity"] == 4096 and x["rows"] == 2048 and x["whole"] == [], x
    ply = os.path.join(out, "point_cloud", "iteration_6", "point_cloud.ply")
    m = tsplats.load_ply(ply, device=CPU)
    assert int(m.num_live()) == 40  # the whole model: rank 1's segment holds none of them
    model, adam, step, _ = tckpt.load_checkpoint(os.path.join(out, "chkpnt6.npz"), device=CPU)
    assert step == 6 and adam.count == 6 and model.capacity == 4096
    np.testing.assert_array_equal(model.xyz.detach().numpy()[model.live.numpy()],
                                  m.xyz.detach().numpy()[:40])
    with open(os.path.join(out, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f if "total_points" in line]
    assert [x["total_points"] for x in logged] == [40]  # rank 0's test report, every rank's
    again = tsplats.load_ply(os.path.join(resumed, "point_cloud", "iteration_9",
                                          "point_cloud.ply"), device=CPU)
    assert int(again.num_live()) == 40
    assert not np.array_equal(again.xyz.detach().numpy()[:40], m.xyz.detach().numpy()[:40])
