"""tpu2dgs_torch's tiled backend against tpu2dgs's.

  * selection, bit-equal on the same inputs: searchsorted_rows,
    bin_square's compaction, tile lists, tile and bin counts (with
    select_coarse's row groups forced small too), and select_rows against
    the JAX select kernel in interpret mode;
  * render(backend="tiled") against JAX's at tests/test_tiled.py's shapes
    and tolerances: outputs at 72x56 with 200 splats (1e-4), gradients at
    48x48 with 64 splats (rtol 2e-3, atol 2e-5);
  * rasterize_rows at tile-row offset 2 with overflowing tiles, on the
    same preprocessed splats, and the overflow counters of a clustered
    scene against the demand of its lists.

PyTorch runs on one thread, and the file keeps to six items
(tests/test_torch_oracle.py says why of both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_tiled import _cam, _random_scene, _settings, KEYS
from tests.test_torch_core import jax_preprocess, port_cam, to_torch
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.raster import binning as jbin
from tpu2dgs.raster import select_kernel as jsel
from tpu2dgs.raster import tiled as jtiled
from tpu2dgs.raster.api import render as jrender
from tpu2dgs_torch.raster import api as tapi
from tpu2dgs_torch.raster import binning as tbin
from tpu2dgs_torch.raster import select_kernel as tsel
from tpu2dgs_torch.raster import tiled as ttiled
from tpu2dgs_torch.raster.preprocess import SplatScreen

BG = np.array([0.1, 0.2, 0.3], np.float32)
TILED = dict(tile_px=16, coarse_tiles=2, bin_capacity=256, tile_capacity=256)
NAMES = ["xyz", "scaling", "rotation", "opacity", "features", "mean2d_offset"]


def _same_splats(w, h, n, seed, **kw):
    """The JAX package's preprocess output and the same values as the
    port's SplatScreen."""
    js = jax_preprocess(*_random_scene(n=n, seed=seed, **kw), _cam(w, h), w, h, 3)
    return js, SplatScreen(*(to_torch(np.asarray(a)) for a in js))


def _equal(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=msg)


# -- selection, bit-equal ---------------------------------------------------------


def test_searchsorted_rows_bit_equal():
    rng = np.random.default_rng(5)
    hits = rng.random((7, 37)) < np.array([0.0, 0.05, 0.3, 0.6, 0.9, 1.0, 0.5])[:, None]
    csum = np.cumsum(hits, axis=1).astype(np.int32)
    targets = np.arange(1, 41, dtype=np.int32)  # past every row's total
    want = np.asarray(jbin.searchsorted_rows(jnp.asarray(csum), jnp.asarray(targets)))
    got = tbin.searchsorted_rows(to_torch(csum), to_torch(targets)).numpy()
    reached = targets[None, :] <= csum[:, -1:]
    _equal(want[reached], got[reached])
    assert reached.any() and (~reached).any()
    # Past a row's total the port returns M, as both docstrings say; the JAX
    # binary search returns M or M + 1 there, by how many of its steps are
    # left once it converges (ROADMAP.md, reference faults). No selection
    # reads those slots: first_k_hits zero-fills them.
    assert (got[~reached] == 37).all() and np.isin(want[~reached], (37, 38)).all()
    hit = to_torch(hits)
    for a, b in zip(jbin.first_k_hits(jnp.asarray(hits), 40), tbin.first_k_hits(hit, 40)):
        _equal(a, b.numpy())


def test_bin_square_bit_equal(monkeypatch):
    """Compaction, coarse and fine lists and counts, with select_coarse's
    rows in one group and cut to 3 bins a group on both sides."""
    w, h = 72, 56
    js, ts = _same_splats(w, h, 200, 1)
    _bin_square_equal(js, ts, w, h)
    monkeypatch.setattr(jbin, "_MAX_ELEMENTS", 3 * 200)
    monkeypatch.setattr(tbin, "_MAX_ELEMENTS", 3 * 200)
    _bin_square_equal(js, ts, w, h)


def _bin_square_equal(js, ts, w, h):
    nty = -(-h // 16)
    jset = _settings(w, h, "tiled", **TILED)
    tset = tapi.RasterSettings(w, h, backend="tiled", **TILED)
    jout = jtiled.bin_square(js, jset, nty, 0, 128, 64, 200)
    tout = ttiled.bin_square(ts, tset, nty, 0, 128, 64, 200)
    for f in jout[0]._fields:
        _equal(jout[0]._asdict()[f], getattr(tout[0], f).numpy(), f)
    for a, b, name in zip(jout[1:], tout[1:], ("tile_ids", "tile_valid", "counts",
                                               "bin_counts")):
        _equal(a, b.numpy(), name)
    assert int(np.asarray(jout[3]).max()) > 64  # some tile lists truncated
    assert int(np.asarray(jout[4]).max()) > 128


SELECT_CASES = ["random", "parent_counts", "padded"]


def _select_case(name):
    """The cases of tests/test_select_kernel.py: random boxes and rows over
    3 parents, the same with live parent counts, M = 300 padded to 1024."""
    rng = np.random.default_rng(0)
    if name == "padded":
        m = 300
        cx0 = np.linspace(0, 500, m, dtype=np.float32)[None]
        boxes = (cx0, cx0 + 30.0, np.zeros((1, m), np.float32),
                 np.full((1, m), 50.0, np.float32))
        rects = tuple(np.array([v], np.float32) for v in (100.0, 220.0, 0.0, 10.0))
        return rects, boxes, np.zeros(1, np.int32), 128, None
    np_, m, r = 3, 1024, 12
    cx0 = rng.uniform(0, 800, (np_, m)).astype(np.float32)
    cy0 = rng.uniform(0, 800, (np_, m)).astype(np.float32)
    boxes = (cx0, cx0 + rng.uniform(5, 60, (np_, m)).astype(np.float32),
             cy0, cy0 + rng.uniform(5, 60, (np_, m)).astype(np.float32))
    rx0 = rng.uniform(0, 700, r).astype(np.float32)
    ry0 = rng.uniform(0, 700, r).astype(np.float32)
    parent = rng.integers(0, np_, r).astype(np.int32)
    counts = None
    if name == "parent_counts":
        counts = rng.integers(0, m, np_).astype(np.int32)[parent]
        for p in range(np_):  # candidates past the count never hit
            live = rng.integers(0, m)
            boxes[0][p, live:] = 1e9
    return (rx0, rx0 + 127, ry0, ry0 + 63), boxes, parent, 256, counts


def test_select_rows_bit_equal():
    for name in SELECT_CASES:
        rects, boxes, parent, cap, counts = _select_case(name)
        jpos, jcnt = jsel.select_rows(
            tuple(map(jnp.asarray, rects)), tuple(map(jnp.asarray, boxes)),
            jnp.asarray(parent), cap,
            parent_counts=None if counts is None else jnp.asarray(counts), interpret=True)
        tpos, tcnt = tsel.select_rows(
            tuple(map(to_torch, rects)), tuple(map(to_torch, boxes)), to_torch(parent), cap,
            parent_counts=None if counts is None else to_torch(counts))
        assert tpos.dtype == torch.int32 and tcnt.dtype == torch.int32
        _equal(jpos, tpos.numpy(), f"{name} pos")
        _equal(jcnt, tcnt.numpy(), f"{name} counts")
        assert int(tcnt.max()) > 0, name


# -- the tiled backend against JAX's ------------------------------------------------


def _tiled_outputs():
    w, h = 72, 56  # not multiples of 16: edge tiles are cropped
    scene = _random_scene(n=200, seed=1)
    jout = jax.jit(lambda *a: jrender(_cam(w, h), _settings(w, h, "tiled", **TILED), *a,
                                      jnp.asarray(BG)))(*scene)
    tout = tapi.render(port_cam(w, h), tapi.RasterSettings(w, h, backend="tiled", **TILED),
                       *map(to_torch, scene), to_torch(BG), device="cpu")
    return jout, tout


def test_tiled_matches_jax():
    """Outputs at 72x56 (200 splats) and gradients at 48x48 (64 splats)."""
    jout, tout = _tiled_outputs()
    for k in KEYS:
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    _equal(jout["radii"], tout["radii"].numpy(), "radii")
    for k in ("tile_overflow_frac", "bin_overflow_frac", "tile_count_max", "bin_count_max",
              "strip_work"):
        assert float(tout[k]) == float(jout[k]), k
    for name, (gj, gt) in _tiled_grads().items():
        gj = np.asarray(gj)
        assert float(np.abs(gj).max()) > 0.0, name
        np.testing.assert_allclose(gt.numpy(), gj, rtol=2e-3, atol=2e-5, err_msg=name)


def _tiled_grads():
    w = h = 48
    scene = _random_scene(n=64, seed=2)
    offset = np.zeros((64, 2), np.float32)
    caps = dict(bin_capacity=128, tile_capacity=128)
    bg = np.full(3, 0.05, np.float32)

    def loss(out, xp):  # tests/test_tiled.py::test_tiled_matches_oracle_gradients
        return (xp.sum(out["render"] ** 2) + xp.sum(out["rend_dist"])
                + 0.1 * xp.sum(out["rend_normal"] * out["surf_normal"]))

    gj = jax.jit(jax.grad(
        lambda *a: loss(jrender(_cam(w, h), _settings(w, h, "tiled", **caps), *a[:5],
                                jnp.asarray(bg), mean2d_offset=a[5]), jnp),
        argnums=tuple(range(6))))(*scene, jnp.asarray(offset))
    targs = [to_torch(a).requires_grad_() for a in (*scene, offset)]
    out = tapi.render(port_cam(w, h), tapi.RasterSettings(w, h, backend="tiled", **caps),
                      *targs[:5], to_torch(bg), mean2d_offset=targs[5], device="cpu")
    gt = torch.autograd.grad(loss(out, torch), targs)
    return dict(zip(NAMES, zip(gj, gt)))


def test_rasterize_rows_at_an_offset():
    """Tile rows 2-3 of 72x56 (coarse_tiles 2) at a tile capacity of 64,
    which some of their tiles overflow: JAX's strip and counters, and the
    same rows of the port's full image."""
    w, h = 72, 56
    js, ts = _same_splats(w, h, 200, 1)
    caps = dict(TILED, tile_capacity=64)
    jset = _settings(w, h, "tiled", **caps)
    tset = tapi.RasterSettings(w, h, backend="tiled", **caps)
    jimg, jmaps, jaux = jax.jit(lambda sp, bg: jtiled.rasterize_rows(
        sp, jset, bg, 2, 2, return_aux=True))(js, jnp.asarray(BG))
    timg, tmaps, taux = ttiled.rasterize_rows(ts, tset, to_torch(BG), 2, 2, return_aux=True)
    assert timg.shape == (32, 80, 3)
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), rtol=1e-4, atol=1e-4)
    for k in jmaps:
        np.testing.assert_allclose(tmaps[k].numpy(), np.asarray(jmaps[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    for k in jaux:
        assert int(taux[k]) == int(jaux[k]), k
    assert int(taux["tile_overflow"]) > 0 and float(tmaps["_aux_tile_overflow_frac"]) > 0.0
    full_img, full_maps = ttiled.rasterize_rows(ts, tset, to_torch(BG), 0, 4)
    np.testing.assert_allclose(timg.numpy(), full_img[32:64].numpy(), rtol=1e-6, atol=1e-6)
    for k in ("alpha", "depth_median", "distortion"):
        np.testing.assert_allclose(tmaps[k].numpy(), full_maps[k][32:64].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert 0.0 < float(tmaps["_aux_strip_work"]) < float(full_maps["_aux_strip_work"])


def test_overflow_counters_report_demand():
    """tests/test_tiled.py::test_tiled_overflow_reported on the port: 40
    splats clustered in a 32x32 view against a tile capacity of 8; the
    counters are the raw demand of bin_square's lists."""
    w = h = 32
    _, ts = _same_splats(w, h, 40, 3, spread=0.1)
    settings = tapi.RasterSettings(w, h, backend="tiled", tile_px=16, coarse_tiles=2,
                                   bin_capacity=64, tile_capacity=8)
    _, maps, aux = ttiled.rasterize_tiled(ts, settings, torch.zeros(3), return_aux=True)
    assert int(aux["tile_count_max"]) > 8 and int(aux["tile_overflow"]) > 0
    *_, counts, bin_counts = ttiled.bin_square(ts, settings, 2, 0, 64, 8, 40)
    assert int(aux["tile_overflow"]) == int((counts > 8).sum())
    assert float(maps["_aux_tile_overflow_frac"]) == float((counts > 8).float().mean())
    assert float(maps["_aux_bin_count_max"]) == float(bin_counts.max())
    assert float(maps["_aux_strip_work"]) == float(counts.clamp(max=8).sum())
