"""tpu2dgs_torch CUDA backend (plain versions, on the CPU) vs the JAX
Pallas backend in interpret mode: binning bit-equal, the forward blend
allclose 1e-5, and the whole render allclose at the repo's 2e-4 with
radii and overflow counters equal."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_tiled import KEYS, _cam, _random_scene, _settings
from tests.test_torch_core import port_cam, to_torch
from tpu2dgs.raster import binning as jbin
from tpu2dgs.raster import pallas_backend as jpb
from tpu2dgs.raster import preprocess as jpre
from tpu2dgs.raster.api import render as jrender
from tpu2dgs_torch.core import sh as tsh
from tpu2dgs_torch.core import transforms as ttf
from tpu2dgs_torch.raster import api as tapi
from tpu2dgs_torch.raster import binning as tbin
from tpu2dgs_torch.raster import cuda_backend as tcb
from tpu2dgs_torch.raster import preprocess as tpre

COUNTERS = ["tile_overflow_frac", "grad_pack_overflow_frac", "tile_count_max",
            "grad_pack_max", "strip_work", "bin_overflow_frac", "col_overflow_frac",
            "vis_overflow", "bin_count_max", "col_count_max"]


def _basic():
    # tests/test_pallas.py::test_pallas_matches_oracle_outputs
    w, h = 150, 90  # not multiples of (128, 16): exercises edge cropping
    return (w, h, _random_scene(n=120, seed=21), np.array([0.15, 0.05, 0.3], np.float32),
            dict(bin_capacity=256, tile_capacity=128))


def _multigroup():
    # tests/test_pallas.py::test_pallas_group_unaligned_capacity: a tile
    # capacity of 384 (rounded to whole 256-record groups) and tiles deeper
    # than one group
    w, h = 128, 32
    xyz, scaling, rotation, opacity, features = _random_scene(n=400, seed=31)
    xyz = xyz.at[:, :2].set(xyz[:, :2] * 0.15)
    return (w, h, (xyz, scaling, rotation, opacity, features),
            np.array([0.1, 0.2, 0.05], np.float32),
            dict(bin_capacity=512, tile_capacity=384))


SCENES = {"basic": _basic, "multigroup": _multigroup}


@pytest.fixture(scope="module")
def basic_binning():
    """The basic scene through JAX preprocess + binning (interpret mode)."""
    w, h, scene, _, caps = _basic()
    splats = jpre.preprocess(*scene, _cam(w, h), w, h, 3)
    n = scene[0].shape[0]
    comp = jbin.compact_visible(splats, n)
    rec = jpb.pack_records(splats)
    nbx, nty = -(-w // jpb.BX), -(-h // jpb.BY)
    cap = min(caps["tile_capacity"], n)
    bin_cap = max(min(caps["bin_capacity"], n), cap)
    out = jpb._bin_records(comp.x0, comp.x1, comp.y0, comp.y1, comp.num_visible, rec,
                           nbx, nty, bin_cap, cap, 0, ids=comp.perm, interpret=True)
    return dict(splats=splats, rec=rec, nbx=nbx, nty=nty, cap=cap, bin_cap=bin_cap,
                out=out, n=n)


def test_bin_records_bit_equal(basic_binning):
    b = basic_binning
    ts = tpre.SplatScreen(*(to_torch(a) for a in b["splats"]))
    comp = tbin.compact_visible(ts, b["n"])
    rec = tcb.pack_records(ts)
    np.testing.assert_allclose(rec.numpy(), np.asarray(b["rec"]), rtol=1e-6, atol=1e-4)
    # binning is held bit-equal on identical records
    got = tcb._bin_records(comp.x0, comp.x1, comp.y0, comp.y1, comp.num_visible,
                           to_torch(b["rec"]), b["nbx"], b["nty"], b["bin_cap"], b["cap"],
                           ids=comp.perm)
    for name, g, j in zip(["rec3", "counts", "bin_counts", "col_counts"], got, b["out"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j), err_msg=name)
    assert int(got[1].sum()) > 0


def test_blend_plain_matches_jax(basic_binning):
    b = basic_binning
    rec3, raw_counts = b["out"][0], b["out"][1]
    capk = rec3.shape[2]
    counts = jnp.minimum(raw_counts, capk).astype(jnp.int32)
    rec3_t, counts_t = to_torch(rec3), to_torch(counts)
    jout = jpb._blend_call(rec3, counts, jnp.zeros((1,), jnp.int32), nty=b["nty"],
                           capk=capk, interpret=True)
    # on a CPU tensor the dispatching wrapper runs the plain version
    with mock.patch.object(tcb, "blend_tiles_plain", wraps=tcb.blend_tiles_plain) as plain:
        tout = tcb.blend_tiles(rec3_t, counts_t, b["nty"])
    assert plain.call_count == 1
    assert tout.shape == jout.shape
    got, want = tout.numpy(), np.asarray(jout)
    bad = ~np.isclose(got, want, rtol=1e-5, atol=1e-5)
    if bad.any():
        # A failure explains itself: how many values, how far, which output
        # channels and pixels, and whether either side changes from one call
        # to the next within this process.
        again_t = tcb.blend_tiles(rec3_t, counts_t, b["nty"]).numpy()
        again_j = np.asarray(jpb._blend_call(rec3, counts, jnp.zeros((1,), jnp.int32),
                                             nty=b["nty"], capk=capk, interpret=True))
        tile, chan, row, col = np.nonzero(bad)
        where = [f"(tile {t}, pixel ({r},{c}), channel {ch}: port {got[t, ch, r, c]!r} "
                 f"jax {want[t, ch, r, c]!r})"
                 for t, ch, r, c in list(zip(tile, chan, row, col))[:8]]
        pytest.fail(
            f"{int(bad.sum())} of {bad.size} values differ beyond rtol=atol=1e-5; largest "
            f"|d| {float(np.abs(got - want)[bad].max())!r}; channels "
            f"{sorted(set(chan.tolist()))}; tiles {sorted(set(tile.tolist()))[:16]}; first: "
            f"{'; '.join(where)}. Second call in this process: port bits "
            f"{'equal' if np.array_equal(again_t, got) else 'DIFFER'}, jax bits "
            f"{'equal' if np.array_equal(again_j, want) else 'DIFFER'}; largest |d| of the "
            f"second calls {float(np.abs(again_t - again_j).max())!r}; torch threads "
            f"{torch.get_num_threads()}")


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_render_matches_jax_pallas(scene):
    w, h, arrays, bg, caps = SCENES[scene]()
    out_j = jrender(_cam(w, h), _settings(w, h, "pallas", debug=True, **caps),
                    *arrays, jnp.asarray(bg))
    out_t = tapi.render(port_cam(w, h), tapi.RasterSettings(w, h, **caps),
                        *map(to_torch, arrays), to_torch(bg), device="cpu")
    for k in KEYS:
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   rtol=2e-4, atol=2e-4, err_msg=k)
    for k in ["radii", "visibility_filter", *COUNTERS]:
        np.testing.assert_array_equal(out_t[k].numpy(), np.asarray(out_j[k]), err_msg=k)
    assert set(out_t) == set(out_j)
    if scene == "multigroup":
        assert float(out_t["tile_count_max"]) > 256, "needs a multi-group walk"


def test_effective_counts_respect_early_exit():
    # tests/test_pallas.py::test_effective_counts_respect_early_exit
    counts = torch.tensor([300, 64, 0, 5], dtype=torch.int32)
    out = torch.full((4, 16, 2, 2), -1.0)
    out[0, 12] = 130.0
    out[1, 12, 0, 0] = 63.0
    eff = tcb._effective_counts(counts, out, 128)
    np.testing.assert_array_equal(eff.numpy(), [256, 128, 0, 0])


def _port_options(case):
    """Render keyword arguments that must reproduce the default render."""
    w, h, arrays, _, _ = _basic()
    xyz, scaling, rotation, opacity, features = map(to_torch, arrays)
    if case == "axes_override":
        return dict(axes_override=ttf.splat_axes(scaling, rotation))
    if case == "override_color":
        dirs = ttf.normalize(xyz)  # the test camera sits at the origin
        rgb = torch.clamp(tsh.eval_sh(3, features.swapaxes(-1, -2), dirs) + 0.5, min=0.0)
        return dict(override_color=rgb)
    return {case: True}


@pytest.mark.parametrize("case", ["axes_override", "compute_cov3d_python",
                                  "convert_shs_python", "override_color"])
def test_render_options_match_default(case):
    """The reference PipelineParams paths (SH and tangent axes evaluated
    outside preprocess) render what the default path renders."""
    w, h, arrays, bg, caps = _basic()
    args = (port_cam(w, h), tapi.RasterSettings(w, h, **caps), *map(to_torch, arrays),
            to_torch(bg))
    ref = tapi.render(*args, device="cpu")
    got = tapi.render(*args, device="cpu", **_port_options(case))
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_median_depth_ratio_and_unported_paths():
    w, h, arrays, bg, caps = _basic()
    args = (port_cam(w, h), tapi.RasterSettings(w, h, depth_ratio=1.0, **caps),
            *map(to_torch, arrays), to_torch(bg))
    out = tapi.render(*args, device="cpu")
    assert torch.equal(out["surf_depth"], out["depth_median"])
    with pytest.raises(NotImplementedError):
        tapi.render(*args, device="cpu", shard_splats=True)
    with pytest.raises(NotImplementedError):
        tapi.render(args[0], tapi.RasterSettings(w, h, backend="tiled"), *args[2:],
                    device="cpu")
    with pytest.raises(ValueError):
        tapi.RasterSettings(w, h, backend="pallas")
