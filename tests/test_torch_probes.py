"""tpu2dgs_torch probe kernels' plain versions against the TPU kernels in
interpret mode, on the CPU.

  * select_counts (K4) against tpu2dgs.raster.select_kernel.select_counts
    (interpret=True) and against the port's own select_values counts:
    bit-equal, on the two cases of tests/test_select_kernel.py rebuilt
    from numpy, with a parent count of 0 and counts that are no multiple
    of 1024.
  * the reduction probes (K5, K6) against scripts/reduce_probe.py's two
    kernels, run through the same pallas_call with interpret=True at 4
    steps: element 0 within relative 1e-6 (all three add the same float32
    terms in another order), and every element of the port's row within
    1e-6 of a float64 sum.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tpu2dgs.raster import select_kernel as jselect
from tpu2dgs_torch.eval import bin_probe, reduce_probe
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


# -- the reduction probes ------------------------------------------------------

STEPS = 4


@pytest.fixture(scope="module")
def tpu_probe():
    """scripts/reduce_probe.py as a module, with its STEPS set to 4 (its
    kernels read the global when they are traced)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "reduce_probe.py")
    spec = importlib.util.spec_from_file_location("tpu_reduce_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.STEPS = STEPS
    return mod


def _interpret(mod, kernel, scratch_shape, x):
    """The pallas_call of scripts/reduce_probe.py:run, in interpret mode."""
    f = pl.pallas_call(
        kernel,
        grid=(1,),
        in_specs=[pl.BlockSpec((1, mod.BY, mod.BX), lambda i: (0, 0, 0))],
        out_specs=pl.BlockSpec((1, 1), lambda i: (0, 0), memory_space=pltpu.SMEM),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        scratch_shapes=[pltpu.VMEM(scratch_shape, jnp.float32)],
        interpret=True,
    )
    return float(f(jnp.asarray(x))[0, 0])


def _float64_row(base, steps):
    b = base.astype(np.float64)
    acc = np.zeros(base.shape[1])
    for s in range(steps):
        for k in range(16):
            f = float(s * 16 + k + 1)
            acc += (k + 1) * (b * f + f).sum(axis=0)
    return acc


@pytest.mark.parametrize("name", ["reduce_probe_shuffle", "reduce_probe_mma",
                                  "reduce_probe_plain"])
def test_reduce_probe_matches_tpu_kernels(tpu_probe, name):
    base = np.random.default_rng(0).random((1, 16, 128), dtype=np.float32)
    vpu = _interpret(tpu_probe, tpu_probe.kernel_vpu, (2, 8, 128), base)
    mxu = _interpret(tpu_probe, tpu_probe.kernel_mxu, (256, 128), base)
    before = dict(native.LAUNCHES)
    got = getattr(reduce_probe, name)(_t(base[0]), STEPS)
    assert dict(native.LAUNCHES) == before
    assert got.shape == (128,) and got.dtype == torch.float32
    want = _float64_row(base[0], STEPS)
    np.testing.assert_allclose(float(got[0]), vpu, rtol=1e-6)
    np.testing.assert_allclose(float(got[0]), mxu, rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose([vpu, mxu], want[0], rtol=1e-6)


def test_reduce_probe_refuses_bad_input():
    with pytest.raises(ValueError, match="float32"):
        reduce_probe.reduce_probe_shuffle(torch.zeros((16, 128), dtype=torch.float64), 1)
    with pytest.raises(ValueError, match="16,128"):
        reduce_probe.reduce_probe_mma(torch.zeros((8, 128)), 1)
    assert float(reduce_probe.reduce_probe_plain(torch.ones((16, 128)), 0).abs().max()) == 0.0
    assert reduce_probe.probe_input(0, "cpu").shape == (16, 128)


@pytest.mark.parametrize("probe", [bin_probe, reduce_probe])
def test_probes_need_a_gpu(probe, monkeypatch):
    """The probe entry points time kernels on the card: no card, no run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.main([])
    with pytest.raises(RuntimeError, match="needs a GPU"):
        probe.run(device="cpu")
