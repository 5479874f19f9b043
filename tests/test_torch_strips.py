"""The cuda backend's strips and windows (its plain versions, on the CPU)
against the JAX Pallas backend in interpret mode, and against the port's
own full-frame render.

  * K2 and K3 (`blend_tiles_plain`, `blend_tiles_backward_plain` through
    their wrappers) at tile-row offsets 0 and 3 against JAX `_blend_call`
    and `_blend_bwd_call`, on the full frame's lists of the four tile rows
    from that offset: forward at rtol = atol = 1e-5
    (tests/test_torch_render.py), backward after the scatter at
    tests/test_torch_backward.py's rtol 1e-4 / atol 1e-5 x max|grad|, bar
    at most one value within ten times that and no further than JAX from
    the plain version run in float64;
  * `_bin_records` of a strip (tile_row0 = 4) and of a window (rows 3 to 7
    of a full-height grid) bit-equal to JAX's `_bin_records`;
  * `rasterize_cuda` strips, stitched, against JAX `rasterize_pallas` on
    the same strips (2e-4) and bit-equal to the port's full frame;
  * a window at tile_row0 != 0 equal to the full frame's rows. The JAX
    backend compares its local rows with the window's global bounds
    (`pallas_backend.py:1086-1092,1108-1110`), right only at tile_row0 = 0,
    the one place it uses a window; the port compares global rows, and this
    case is not held against JAX.

One scene, 150x160 pixels (2 x 10 tiles) of 150 splats, through JAX's
preprocess, once per module. PyTorch runs on one thread
(tests/test_torch_threads.py's `one_torch_thread`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_tiled import _cam, _random_scene, _settings
from tests.test_torch_core import jax_compact, jax_pack, jax_preprocess, to_torch
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.raster import pallas_backend as jpb
from tpu2dgs_torch.raster import api as tapi
from tpu2dgs_torch.raster import binning as tbin
from tpu2dgs_torch.raster import cuda_backend as tcb
from tpu2dgs_torch.raster.preprocess import SplatScreen

W, H = 150, 160
NTY = -(-H // tcb.BY)  # 10
NBX = -(-W // tcb.BX)  # 2
BG = np.array([0.15, 0.05, 0.3], np.float32)
CAPS = dict(bin_capacity=256, tile_capacity=128)
MAPS = ("depth_expected", "alpha", "normal", "depth_median", "distortion")
# K3 after the scatter: both float32 sides lie up to 6.7e-5 x max|grad| from
# the same arithmetic run in float64 here (3e-5 to 4e-5 on the scene of
# tests/test_torch_backward.py, whose tolerance with JAX, rtol 1e-4 / atol
# 1e-5 x max|grad|, rests on that). They part past it at one value of 2850
# at row0 = 0, with no offset: port 16.96517, JAX 16.96174, float64
# 16.96421. One value may lie past the tolerance, within ten times it, if it
# is no further from float64 than JAX's; any more is a fault.


@pytest.fixture(scope="module")
def scene():
    """JAX's preprocessed splats, compaction and records, and the same on
    the port's side."""
    arrays = _random_scene(n=150, seed=41)
    n = arrays[0].shape[0]
    splats = jax_preprocess(*arrays, _cam(W, H), W, H, 3)
    comp = jax_compact(splats, n)
    rec = jax_pack(splats)
    ts = SplatScreen(*(to_torch(a) for a in splats))
    tcomp = tbin.compact_visible(ts, n)
    cap = min(CAPS["tile_capacity"], n)
    bin_cap = max(min(CAPS["bin_capacity"], n), cap)
    settings = tapi.RasterSettings(W, H, **CAPS)
    return dict(arrays=arrays, splats=splats, comp=comp, rec=rec, ts=ts, tcomp=tcomp, n=n,
                cap=cap, bin_cap=bin_cap, settings=settings)


def _jax_bins(s, nty, tile_row0, **window):
    c = s["comp"]
    return jpb._bin_records(c.x0, c.x1, c.y0, c.y1, c.num_visible, s["rec"], NBX, nty,
                            s["bin_cap"], s["cap"], tile_row0, ids=c.perm, interpret=True,
                            **window)


def _port_bins(s, nty, tile_row0, **window):
    c = s["tcomp"]
    return tcb._bin_records(c.x0, c.x1, c.y0, c.y1, c.num_visible, to_torch(s["rec"]),
                            NBX, nty, s["bin_cap"], s["cap"], tile_row0, ids=c.perm, **window)


@pytest.fixture(scope="module")
def full_lists(scene):
    """The full frame's lists through JAX's binning (tile t = tix*NTY + tiy)."""
    rec3, raw, _, _ = _jax_bins(scene, NTY, 0)
    capk = rec3.shape[2]
    return np.asarray(rec3), np.asarray(jnp.minimum(raw, capk).astype(jnp.int32)), capk


@pytest.mark.parametrize("row0", [0, 3])
def test_blend_plain_at_row0_matches_jax(full_lists, scene, row0):
    """K2 and K3's plain versions at a tile-row offset, on the full frame's
    lists of tile rows row0 .. row0 + 3."""
    rec3_all, counts_all, capk = full_lists
    nty = 4
    rows = np.arange(NBX)[:, None] * NTY + row0 + np.arange(nty)[None, :]  # column-major
    rec3, counts = rec3_all[rows.reshape(-1)], counts_all[rows.reshape(-1)]
    assert int(counts.sum()) > 0
    jr0 = jnp.full((1,), row0, jnp.int32)
    jout = np.asarray(jpb._blend_call(jnp.asarray(rec3), jnp.asarray(counts), jr0, nty=nty,
                                      capk=capk, interpret=True))
    tout = tcb.blend_tiles(to_torch(rec3), to_torch(counts), nty, row0)  # CPU: plain
    np.testing.assert_allclose(tout.numpy(), jout, rtol=1e-5, atol=1e-5)
    if row0:  # the offset moves the pixels the lists are blended at
        at_zero = tcb.blend_tiles(to_torch(rec3), to_torch(counts), nty, 0)
        assert not torch.equal(at_zero, tout)

    rng = np.random.default_rng(row0)
    dout = rng.normal(size=jout.shape).astype(np.float32)
    dout[:, 9] *= 0.01  # the distortion map's cotangent is small in training
    group = min(jpb.GROUP, capk)
    joff = jpb._packed_offsets(jnp.asarray(counts), jnp.asarray(jout), group)
    demand = int(jnp.sum(jpb._effective_counts(jnp.asarray(counts), jnp.asarray(jout), group)))
    pack_cap = -(-demand // group) * group + group
    jd = np.asarray(jpb._blend_bwd_call(jnp.asarray(rec3), jnp.asarray(counts), joff, jr0,
                                        jnp.asarray(jout), jnp.asarray(dout), nty=nty,
                                        capk=capk, pack_cap=pack_cap, interpret=True))
    jd = jd.reshape(-1, jpb.OUTREC)
    jsum = np.zeros((scene["n"], jpb.OUTREC - 1), np.float64)
    np.add.at(jsum, jd[:demand, -1].astype(np.int64), jd[:demand, :-1].astype(np.float64))
    args = [to_torch(a) for a in (rec3, counts, np.asarray(joff), jout, dout)]
    td = tcb.blend_tiles_backward(*args, nty, pack_cap, row0)  # CPU: plain
    np.testing.assert_array_equal(td.numpy()[:demand, -1], jd[:demand, -1])
    eff = tcb._effective_counts(args[1], args[3], group)
    tsum = tcb.scatter_packed(td, eff, scene["n"]).numpy()
    # The same arithmetic in float64, from the float64 forward: the witness
    # both float32 sides are held to.
    r64 = to_torch(rec3).double()
    out64 = tcb.blend_tiles_plain(r64, args[1], nty, row0)
    d64 = tcb.blend_tiles_backward_plain(r64, args[1], args[2], out64, args[4].double(), nty,
                                         pack_cap, row0)
    s64 = tcb.scatter_packed(d64, eff, scene["n"]).numpy()[:, :19]
    scale = float(np.abs(s64).max())
    assert scale > 0.0
    port = tsum[:, :19]
    # at the backward file's tolerance, bar at most one value that is within
    # ten times it and no further from float64 than JAX
    jmax = float(np.abs(jsum).max())
    near = np.isclose(port, jsum, rtol=1e-4, atol=1e-5 * jmax)
    past = np.argwhere(~near)
    assert len(past) <= 1, past[:8]
    for i, j in past:
        assert np.isclose(port[i, j], jsum[i, j], rtol=1e-3, atol=1e-4 * jmax), (i, j)
        assert abs(port[i, j] - s64[i, j]) <= abs(jsum[i, j] - s64[i, j]), (i, j)


@pytest.mark.parametrize("mode", ["strip", "window"])
def test_bin_records_strip_and_window_bit_equal(scene, mode):
    """A strip of 4 tile rows from tile row 4, and the window [3, 7) of a
    full-height grid (tile_row0 = 0, the JAX package's balanced mode):
    lists, counts, bin and column counts bit-equal to JAX's."""
    if mode == "strip":
        args = (4, 4)
        kw = {}
    else:
        args = (NTY, 0)
        kw = dict(row_lo=3, row_hi=7)
    want = _jax_bins(scene, *args, **kw)
    got = _port_bins(scene, *args, **kw)
    for name, g, j in zip(["rec3", "counts", "bin_counts", "col_counts"], got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j), err_msg=name)
    counts = got[1].numpy().reshape(NBX, -1)
    assert counts.sum() > 0
    if mode == "window":
        assert counts[:, :3].sum() == 0 and counts[:, 7:].sum() == 0


def test_strips_stitch_to_jax_and_full_frame(scene):
    """rasterize_cuda (plain) on strips of 4 tile rows from rows 0, 4 and 8,
    stitched and cropped: against JAX rasterize_pallas on each strip, and
    bit-equal to the port's full frame."""
    s = scene
    bg = to_torch(BG)
    full_img, full_maps = tcb.rasterize_cuda(s["ts"], s["settings"], bg, plain=True)
    imgs, maps = [], []
    jsettings = _settings(W, H, "pallas", debug=True, **CAPS)
    # one compile for the three strips: the strip's first row is traced
    jstrip = jax.jit(lambda sp, r0: jpb.rasterize_pallas(
        sp, jsettings, jnp.asarray(BG), interpret=True, tile_row0=r0, nty_local=4))
    for row0 in (0, 4, 8):
        img, allmap = tcb.rasterize_cuda(s["ts"], s["settings"], bg, plain=True,
                                         tile_row0=row0, nty_local=4)
        assert img.shape == (4 * tcb.BY, NBX * tcb.BX, 3)  # uncropped
        jimg, jmap = jstrip(s["splats"], jnp.int32(row0))
        np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=2e-4, atol=2e-4)
        for k in MAPS:
            np.testing.assert_allclose(allmap[k].numpy(), np.asarray(jmap[k]), rtol=2e-4,
                                       atol=2e-4, err_msg=f"{k} at row {row0}")
        for k in ("_aux_tile_count_max", "_aux_grad_pack_max", "_aux_strip_work"):
            assert float(allmap[k]) == float(jmap[k]), (k, row0)
        imgs.append(img)
        maps.append(allmap)
    assert torch.equal(torch.cat(imgs)[:H, :W], full_img)
    for k in MAPS:
        assert torch.equal(torch.cat([m[k] for m in maps])[:H, :W], full_maps[k]), k
    assert sum(float(m["_aux_strip_work"]) for m in maps) == float(full_maps["_aux_strip_work"])


def test_window_off_row_zero_matches_full_frame(scene):
    """A window whose strip starts at tile row 4 (rows [5, 9) rendered on
    the strip of rows 4 .. 8): its rows equal the full frame's, every other
    row of the strip is background, and its lists are the full frame's
    lists of those tiles. With local rows against global bounds (the JAX
    backend's comparison) the window would keep local rows 5 .. 8, image
    rows 9 .. 12, instead."""
    s = scene
    bg = to_torch(BG)
    full_img, full_maps = tcb.rasterize_cuda(s["ts"], s["settings"], bg, plain=True)
    lo, hi, row0, nty = 5, 9, 4, 5
    img, allmap = tcb.rasterize_cuda(s["ts"], s["settings"], bg, plain=True, tile_row0=row0,
                                     nty_local=nty, row_lo=lo, row_hi=hi)
    a, z = (lo - row0) * tcb.BY, (hi - row0) * tcb.BY
    y0 = lo * tcb.BY
    assert torch.equal(img[a:z, :W], full_img[y0:y0 + z - a])
    for k in MAPS:
        assert torch.equal(allmap[k][a:z, :W], full_maps[k][y0:y0 + z - a]), k
    assert torch.equal(img[:a], bg.expand(a, *img.shape[1:]))
    assert float(allmap["alpha"][:a].abs().max()) == 0.0

    rec3, counts, _, _ = _port_bins(s, nty, row0, row_lo=lo, row_hi=hi)
    full3, full_counts, _, _ = _port_bins(s, NTY, 0)
    counts = counts.reshape(NBX, nty)
    full_counts = full_counts.reshape(NBX, NTY)
    assert int(counts[:, 0].sum()) == 0  # tile row 4: outside the window
    assert int(counts.sum()) > 0
    assert torch.equal(counts[:, 1:], full_counts[:, lo:hi])
    rec3 = rec3.reshape(NBX, nty, *rec3.shape[1:])
    full3 = full3.reshape(NBX, NTY, *full3.shape[1:])
    for tix in range(NBX):
        for k in range(lo, hi):
            c = int(full_counts[tix, k].clamp(max=rec3.shape[-1]))
            assert torch.equal(rec3[tix, k - row0, :, :c], full3[tix, k, :, :c]), (tix, k)
