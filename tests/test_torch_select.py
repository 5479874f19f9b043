"""tpu2dgs_torch select and binning vs tpu2dgs: the port's plain
select_values against the JAX select kernel (interpret mode) on identical
numpy inputs, and compact_visible / pack_interval / first_k_hits against
their JAX counterparts. Selections are bit-equal: values and counts."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_tiled import _cam, _random_scene
from tests.test_torch_core import port_cam, to_torch
from tpu2dgs.raster import binning as jbin
from tpu2dgs.raster import pallas_backend as jpb
from tpu2dgs.raster import preprocess as jpre
from tpu2dgs.raster import select_kernel as jsel
from tpu2dgs_torch.raster import binning as tbin
from tpu2dgs_torch.raster import cuda_backend as tcb
from tpu2dgs_torch.raster import preprocess as tpre
from tpu2dgs_torch.raster import select_kernel as tsel


def _box_case(cap):
    """Box-only level: random AABBs, 3 parents, partial parent counts."""
    rng = np.random.default_rng(0)
    NP, M, R = 3, 2500, 12  # M not a multiple of 1024: internal padding
    cx0 = rng.uniform(0, 800, (NP, M)).astype(np.float32)
    cy0 = rng.uniform(0, 800, (NP, M)).astype(np.float32)
    cx1 = cx0 + rng.uniform(5, 300, (NP, M)).astype(np.float32)
    cy1 = cy0 + rng.uniform(5, 300, (NP, M)).astype(np.float32)
    ids = np.broadcast_to(np.arange(M, dtype=np.float32), (NP, M)).copy()
    rx0 = rng.uniform(0, 700, R).astype(np.float32)
    ry0 = rng.uniform(0, 700, R).astype(np.float32)
    rects = (rx0, rx0 + 127, ry0, ry0 + 63)
    parent = rng.integers(0, NP, R).astype(np.int32)
    pcnt = rng.integers(0, M, R).astype(np.int32)
    return dict(row_rects=rects, cand_channels=(cx0, cx1, cy0, cy1, ids),
                parent_of_row=parent, cap=cap, parent_counts=pcnt)


def _exact_case():
    """Exact-only level on real records: one parent of depth-ordered
    records (the L2 input) with _REC_PADS past the visible count."""
    w, h = 256, 128
    splats = jpre.preprocess(*_random_scene(n=300, seed=9), _cam(w, h), w, h, 3)
    comp = jbin.compact_visible(splats, 300)
    rec = np.asarray(jpb.pack_records(splats))[np.asarray(comp.perm)]
    chans = rec.T[None].copy()                         # (1, 24, 300)
    nv = int(comp.num_visible)
    chans[0, :, nv:] = np.asarray(jpb._REC_PADS, np.float32)[:, None]
    tx0 = np.array([0, 128, 0, 128, 64], np.float32)
    ty0 = np.array([0, 0, 64, 64, 32], np.float32)
    return dict(row_rects=(tx0, tx0 + 127, ty0, ty0 + 63), cand_channels=chans,
                parent_of_row=np.zeros(5, np.int32), cap=384,
                parent_counts=np.full(5, nv, np.int32), box_idx=None,
                exact_idx=jpb._EXACT_IDX, pad_vals=jpb._REC_PADS)


CASES = {
    "box": lambda: _box_case(cap=512),
    "exact_rec_pads": _exact_case,
    "box_overflow": lambda: _box_case(cap=128),  # hot rows exceed the cap
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_select_values_matches_jax(case):
    kw = CASES[case]()

    def conv(fn, a):
        if isinstance(a, (tuple, list)):
            return tuple(fn(x) for x in a)
        return fn(a) if isinstance(a, np.ndarray) else a

    jv, jc = jsel.select_values(**{k: conv(jnp.asarray, v) for k, v in kw.items()},
                                interpret=True)
    # on a CPU tensor the dispatching wrapper runs the plain version
    with mock.patch.object(tsel, "_plain", wraps=tsel._plain) as plain:
        tv, tc = tsel.select_values(**{k: conv(to_torch, v) for k, v in kw.items()})
    assert plain.call_count == 1
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int(tc.sum()) > 0
    if case == "box_overflow":
        assert int(tc.max()) > kw["cap"], "the case must overflow a row"
    else:
        assert int(tc.max()) <= kw["cap"]


def test_select_values_refuses_other_devices():
    kw = _box_case(cap=128)
    meta = {k: (tuple(torch.empty(x.shape, device="meta") for x in v)
                if isinstance(v, tuple) else
                torch.empty(v.shape, device="meta") if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}
    with pytest.raises(ValueError, match="cpu or cuda"):
        tsel.select_values(**meta)


def test_binning_primitives_match_jax():
    rng = np.random.default_rng(7)
    lo = np.concatenate([rng.uniform(-3000, 3000, 512),
                         [0.0, -0.5, 1e-6, 799.99, 1e9, -1e9]]).astype(np.float32)
    hi = lo + np.concatenate([rng.uniform(0, 200, 512),
                              [0.0, 1.0, 2e-6, 0.01, -2e9, 2e9]]).astype(np.float32)
    jl, jh = jbin.unpack_interval(jbin.pack_interval(jnp.asarray(lo), jnp.asarray(hi)))
    tl, th = tbin.unpack_interval(tbin.pack_interval(to_torch(lo), to_torch(hi)))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))

    hit = rng.uniform(size=(6, 700)) < 0.3
    for cap in (128, 384):
        jp, jv, jc = jbin.first_k_hits(jnp.asarray(hit), cap)
        tp, tv, tc = tbin.first_k_hits(to_torch(hit), cap)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_compact_visible_matches_jax():
    """Same preprocess outputs (JAX's, converted) -> bit-equal depth order,
    boxes and visible count, ties at equal depth broken by id."""
    w, h = 150, 90
    xyz, *rest = _random_scene(n=200, seed=11)
    xyz = xyz.at[100:110].set(xyz[90])  # exactly equal depths
    live = np.arange(200) % 7 != 0
    js = jpre.preprocess(xyz, *rest, _cam(w, h), w, h, 3, live=jnp.asarray(live))
    ts = tpre.SplatScreen(*(to_torch(a) for a in js))
    jc = jbin.compact_visible(js, 180)
    tc = tbin.compact_visible(ts, 180)
    for name in jbin.Compacted._fields:
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)), err_msg=name)
    # the port's own preprocess agrees on what is visible and where
    ts2 = tpre.preprocess(to_torch(xyz), *map(to_torch, rest), port_cam(w, h), w, h, 3,
                          live=to_torch(live))
    np.testing.assert_array_equal(ts2.visible.numpy(), np.asarray(js.visible))
    np.testing.assert_array_equal(ts2.radius.numpy(), np.asarray(js.radius))


def test_capacity_rounding_matches_jax():
    for x in (1, 127, 128, 129, 255, 256, 257, 383, 384, 2047, 2048, 13440):
        assert tcb._round_group(x) == jpb._round_group(x), x
        assert tcb._round128(x) == jpb._round128(x), x
    assert tcb._REC_PADS == jpb._REC_PADS and tcb._EXACT_IDX == jpb._EXACT_IDX
    assert (tcb.REC, tcb.OUT_CH, tcb.BX, tcb.BY) == (jpb.REC, jpb.OUT_CH, jpb.BX, jpb.BY)
    assert tcb.GROUP == jpb.GROUP
