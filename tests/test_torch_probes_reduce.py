"""The reduction probes' plain versions (K5 `kernel_vpu`, K6 `kernel_mxu`
of scripts/reduce_probe.py) against the TPU kernels in interpret mode,
on the CPU: the script's two kernels run through the same pallas_call
with interpret=True at 4 steps; element 0 within relative 1e-6 (all
three add the same float32 terms in another order), and every element of
the port's row within 1e-6 of a float64 sum. Also the float64 witness
eval.reduce_turns times against, and the probes' refusals."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs_torch.eval import reduce_probe, reduce_turns
from tpu2dgs_torch.native import build as native


def _t(a):
    return torch.from_numpy(np.asarray(a))


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


def test_reduce_probe_f64_witness_is_the_function():
    """eval.reduce_turns' closed form equals the probe's function summed
    term by term in float64, and the plain version is within 1e-6 of it
    at 7 steps."""
    base = reduce_probe.probe_input(0, "cpu")
    steps = 7
    f = (torch.arange(steps * 16, dtype=torch.float64) + 1).reshape(steps, 16)[..., None, None]
    rows = (base.double() * f + f).sum(dim=2)                        # (steps, 16, 128)
    want = (rows * torch.arange(1, 17, dtype=torch.float64)[None, :, None]).sum(dim=(0, 1))
    witness = reduce_turns.reduce_probe_f64(base, steps)
    torch.testing.assert_close(witness, want, rtol=1e-14, atol=0)
    plain = reduce_probe.reduce_probe_plain(base, steps).double()
    assert float(((plain - witness) / witness).abs().max()) <= 1e-6


def test_reduce_probe_refuses_bad_input():
    with pytest.raises(ValueError, match="float32"):
        reduce_probe.reduce_probe_shuffle(torch.zeros((16, 128), dtype=torch.float64), 1)
    with pytest.raises(ValueError, match="16,128"):
        reduce_probe.reduce_probe_mma(torch.zeros((8, 128)), 1)
    assert float(reduce_probe.reduce_probe_plain(torch.ones((16, 128)), 0).abs().max()) == 0.0
    assert reduce_probe.probe_input(0, "cpu").shape == (16, 128)
