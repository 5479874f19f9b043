"""tpu2dgs_torch's binning primitives against tpu2dgs's on identical numpy
inputs, bit-equal: pack_interval / unpack_interval, first_k_hits,
compact_visible (with the port's own preprocess beside it), and the
capacity rounding and record layout constants. select_values is
tests/test_torch_select.py's."""

import jax.numpy as jnp
import numpy as np

from tests.test_tiled import _cam, _random_scene
from tests.test_torch_core import port_cam, to_torch
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.raster import binning as jbin
from tpu2dgs.raster import pallas_backend as jpb
from tpu2dgs.raster import preprocess as jpre
from tpu2dgs_torch.raster import binning as tbin
from tpu2dgs_torch.raster import cuda_backend as tcb
from tpu2dgs_torch.raster import preprocess as tpre


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
