"""tpu2dgs_torch select and binning vs tpu2dgs: the port's plain
select_values against the JAX select kernel (interpret mode) on identical
numpy inputs, bit-equal: values and counts. compact_visible,
pack_interval and first_k_hits are tests/test_torch_select_binning.py's."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_tiled import _cam, _random_scene
from tests.test_torch_core import jax_compact, jax_pack, jax_preprocess, to_torch
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.raster import pallas_backend as jpb
from tpu2dgs.raster import select_kernel as jsel
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
    splats = jax_preprocess(*_random_scene(n=300, seed=9), _cam(w, h), w, h, 3)
    comp = jax_compact(splats, 300)
    rec = np.asarray(jax_pack(splats))[np.asarray(comp.perm)]
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
