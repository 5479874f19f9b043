"""tpu2dgs_torch backward blend (its plain version, on the CPU) vs the JAX
Pallas backward kernel in interpret mode, on the same record lists,
forward outputs and output cotangents: packed offsets and the rows' slot
column exactly equal, gradients compared after the scatter, with room in
the packed array and with a capacity below demand.

Tolerance after the scatter: rtol 1e-4, atol 1e-5 x max|grad|. The walk
divides by 1 - alpha, down to 0.01, so a last-bit difference in exp() or
in the order of a tile's 2048-pixel sum grows a hundredfold: on a
150x90 scene of 120 splats the JAX kernel and the plain version both lay
3e-5 to 4e-5 of a row's largest value away from a float64 run of the same
arithmetic, and as far from each other."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_tiled import _cam
from tests.test_torch_core import jax_compact, jax_pack, jax_preprocess, to_torch
from tests.test_torch_render import _multigroup
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.raster import pallas_backend as jpb
from tpu2dgs_torch.raster import cuda_backend as tcb


@pytest.fixture(scope="module")
def lists():
    """One scene through JAX preprocess, binning and forward blend
    (interpret mode), with a seeded cotangent of the blend output: the
    pileup of tests/test_torch_render.py's multi-group scene (a tile
    capacity of 512 = two staging groups, tiles deeper than one group) on
    a 150x48 image: 2 x 3 tiles, the outer ones shallow or empty, so the
    packed offsets step by different amounts."""
    _, _, scene, _, caps = _multigroup()
    w, h = 150, 48
    n = scene[0].shape[0]
    splats = jax_preprocess(*scene, _cam(w, h), w, h, 3)
    comp = jax_compact(splats, n)
    rec = jax_pack(splats)
    nbx, nty = -(-w // jpb.BX), -(-h // jpb.BY)
    cap = min(caps["tile_capacity"], n)
    bin_cap = max(min(caps["bin_capacity"], n), cap)
    rec3, raw, _, _ = jpb._bin_records(comp.x0, comp.x1, comp.y0, comp.y1, comp.num_visible,
                                       rec, nbx, nty, bin_cap, cap, 0, ids=comp.perm,
                                       interpret=True)
    capk = rec3.shape[2]
    counts = jnp.minimum(raw, capk).astype(jnp.int32)
    row0 = jnp.zeros((1,), jnp.int32)
    out = jpb._blend_call(rec3, counts, row0, nty=nty, capk=capk, interpret=True)
    rng = np.random.default_rng(11)
    dout = rng.normal(size=out.shape).astype(np.float32)
    dout[:, 9] *= 0.01  # the distortion map's cotangent is small in training
    group = min(jpb.GROUP, capk)
    off = jpb._packed_offsets(counts, out, group)
    demand = int(jnp.sum(jpb._effective_counts(counts, out, group)))
    return dict(rec3=rec3, counts=counts, row0=row0, out=out,
                dout=jnp.asarray(dout), off=off, nty=nty, capk=capk, group=group,
                demand=demand, n=n)


def test_packed_offsets_equal(lists):
    b = lists
    got = tcb._packed_offsets(to_torch(b["counts"]), to_torch(b["out"]), b["group"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(b["off"]))
    eff = tcb._effective_counts(to_torch(b["counts"]), to_torch(b["out"]), b["group"])
    assert int(eff.sum()) == b["demand"] > 0
    assert len(set(eff.tolist())) >= 3 and int(eff.max()) > b["group"]  # 0, one, two groups


def _jax_scatter(b, dpack, pack_cap):
    flat = np.asarray(dpack).reshape(-1, jpb.OUTREC)
    written = min(b["demand"], pack_cap)
    idx = flat[:written, -1].astype(np.int64)
    dsum = np.zeros((b["n"], jpb.OUTREC - 1), np.float64)
    np.add.at(dsum, idx, flat[:written, :-1].astype(np.float64))
    return flat[:written], dsum


@pytest.mark.parametrize("room", ["room", "overflow"])
def test_backward_plain_matches_jax_kernel(lists, room):
    b = lists
    if room == "room":
        pack_cap = -(-b["demand"] // b["group"]) * b["group"] + b["group"]
    else:
        pack_cap = max(b["group"], (b["demand"] // 2) // b["group"] * b["group"])
        assert pack_cap < b["demand"]
    jd = jpb._blend_bwd_call(b["rec3"], b["counts"], b["off"], b["row0"], b["out"],
                             b["dout"], nty=b["nty"], capk=b["capk"], pack_cap=pack_cap,
                             interpret=True)
    jrows, jsum = _jax_scatter(b, jd, pack_cap)

    args = [to_torch(b[k]) for k in ("rec3", "counts", "off", "out", "dout")]
    td = tcb.blend_tiles_backward(*args, b["nty"], pack_cap)  # CPU: the plain version
    assert td.shape == (pack_cap, tcb.OUTREC)
    trows = td.numpy()[:jrows.shape[0]]
    # the slot column, and with it which rows were written, exactly
    np.testing.assert_array_equal(trows[:, -1], jrows[:, -1])
    eff = tcb._effective_counts(args[1], args[3], b["group"])
    tsum = tcb.scatter_packed(td, eff, b["n"]).numpy()
    assert tsum.shape == (b["n"], tcb.REC)
    assert float(np.abs(tsum[:, 19:]).max()) == 0.0
    scale = float(np.abs(jsum).max())
    assert scale > 0.0
    np.testing.assert_allclose(tsum[:, :19], jsum, rtol=1e-4, atol=1e-5 * scale)
