"""tpu2dgs_torch probe kernels' plain versions against the TPU kernels in
interpret mode, on the CPU.

  * select_counts (K4) against tpu2dgs.raster.select_kernel.select_counts
    (interpret=True) and against the port's own select_values counts:
    bit-equal, on the two cases of tests/test_select_kernel.py rebuilt
    from numpy, with a parent count of 0 and counts that are no multiple
    of 1024.

The reduction probes (K5, K6) are tests/test_torch_probes_reduce.py's and
tests/test_torch_probes_split.py's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.raster import select_kernel as jselect
from tpu2dgs_torch.eval import synthetic
from tpu2dgs_torch.native import build as native
from tpu2dgs_torch.raster import binning, cuda_backend, preprocess
from tpu2dgs_torch.raster import select_kernel as tselect


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _box_case():
    """AABB test: NP 2, M 1024 and R 10, as tests/test_select_kernel.py;
    the parent counts include 0 and the full list."""
    rng = np.random.default_rng(7)
    NP, M, R = 2, 1024, 10
    cx0 = rng.uniform(0, 800, (NP, M)).astype(np.float32)
    cx1 = cx0 + rng.uniform(5, 60, (NP, M)).astype(np.float32)
    cy0 = rng.uniform(0, 800, (NP, M)).astype(np.float32)
    cy1 = cy0 + rng.uniform(5, 60, (NP, M)).astype(np.float32)
    rx0 = rng.uniform(0, 700, R).astype(np.float32)
    ry0 = rng.uniform(0, 700, R).astype(np.float32)
    pcnt = rng.integers(0, M, R).astype(np.int32)
    pcnt[0], pcnt[1] = 0, M
    return dict(row_rects=(rx0, rx0 + 127, ry0, ry0 + 63), cand_channels=(cx0, cx1, cy0, cy1),
                parent_of_row=rng.integers(0, NP, R).astype(np.int32), parent_counts=pcnt)


def _box_long_case():
    """AABB test over lists of 2500 candidates (padded to 3072 inside)
    with counts that are no multiple of 1024: hits past a count inside its
    last 1024-block still count, whole blocks past it do not."""
    rng = np.random.default_rng(8)
    NP, M, R = 3, 2500, 8
    cx0 = rng.uniform(0, 800, (NP, M)).astype(np.float32)
    cy0 = rng.uniform(0, 800, (NP, M)).astype(np.float32)
    rx0 = rng.uniform(0, 600, R).astype(np.float32)
    ry0 = rng.uniform(0, 600, R).astype(np.float32)
    pcnt = np.array([0, 1, 1023, 1024, 1025, 2047, 2500, 9999], np.int32)
    return dict(row_rects=(rx0, rx0 + 255, ry0, ry0 + 127),
                cand_channels=(cx0, cx0 + 40, cy0, cy0 + 40),
                parent_of_row=rng.integers(0, NP, R).astype(np.int32), parent_counts=pcnt)


def _exact_case():
    """Exact coverage: one parent of real records from a 200-splat,
    256x128 scene in depth order, never-hit pad records past the count."""
    w, h, n = 256, 128, 200
    cam, scene = synthetic.make_bench_scene(w, h, n, device="cpu")
    splats = preprocess.preprocess(*scene, cam, w, h, 3)
    comp = binning.compact_visible(splats, n)
    rec = cuda_backend.pack_records(splats)[comp.perm.long()]
    pads = torch.tensor(cuda_backend._REC_PADS)
    live = torch.arange(n)[:, None] < comp.num_visible
    chans = torch.where(live, rec, pads).T[None].contiguous().numpy()
    tx0 = np.array([0.0, 128.0, 0.0, 128.0], np.float32)
    ty0 = np.array([0.0, 0.0, 64.0, 64.0], np.float32)
    return dict(row_rects=(tx0, tx0 + 127, ty0, ty0 + 63), cand_channels=chans,
                parent_of_row=np.zeros(4, np.int32),
                parent_counts=np.full(4, int(comp.num_visible), np.int32),
                box_idx=None, exact_idx=cuda_backend._EXACT_IDX,
                pad_vals=cuda_backend._REC_PADS)


COUNT_CASES = {"box": _box_case, "box_long": _box_long_case, "exact": _exact_case}


def _convert(case, conv):
    out = dict(case)
    out["row_rects"] = tuple(conv(a) for a in case["row_rects"])
    cand = case["cand_channels"]
    out["cand_channels"] = (tuple(conv(a) for a in cand) if isinstance(cand, tuple)
                            else conv(cand))
    out["parent_of_row"] = conv(case["parent_of_row"])
    out["parent_counts"] = conv(case["parent_counts"])
    return out


@pytest.mark.parametrize("name", sorted(COUNT_CASES))
def test_select_counts_matches_jax_and_select_values(name):
    case = COUNT_CASES[name]()
    before = dict(native.LAUNCHES)
    got = tselect.select_counts(**_convert(case, _t))
    plain = tselect.select_counts_plain(**_convert(case, _t))
    _, k1_counts = tselect.select_values(cap=256, **_convert(case, _t))
    assert dict(native.LAUNCHES) == before  # CPU tensors: no kernel is launched
    want = np.asarray(jselect.select_counts(interpret=True, **_convert(case, jnp.asarray)))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(k1_counts.numpy(), want)
    assert int(got.sum()) > 0
    if name != "exact":
        assert int(got[0]) == 0  # a parent count of 0 walks nothing


def test_select_counts_refuses_bad_arguments():
    case = _convert(_box_case(), _t)
    with pytest.raises(ValueError, match="box_idx or exact_idx"):
        tselect.select_counts(**{**case, "box_idx": None, "pad_vals": (0.0,) * 4})
    with pytest.raises(ValueError, match="13"):
        tselect.select_counts(**{**case, "exact_idx": (0, 1, 2)})
    with pytest.raises(ValueError, match="pad values"):
        tselect.select_counts(**{**case, "pad_vals": (0.0, 1.0)})
    with pytest.raises(ValueError, match="cpu or cuda"):
        tselect.select_counts(**_convert(_box_case(), lambda a: _t(a).to("meta")))
