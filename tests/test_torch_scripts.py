"""tpu2dgs_torch's script entry points (eval/{train_bench, soak_train,
fidelity_probe, capk_probe, strip_balance_probe}.py) against the JAX
package's scripts under scripts/.

What the scripts generate is held bit for bit: the scripts run with their
JAX render, model init and Trainer replaced by recorders, so no JAX render
or train step is compiled, and their orbit cameras, images, points, ground
truth and TrainConfigs are compared with the port's. The port's modules
run on the CPU (the kernels' plain versions) at small sizes; the strip
balance arithmetic gets the same counts and boxes on both sides. PyTorch
runs on one thread, as in tests/test_torch_oracle.py."""

import dataclasses
import os
import sys
import types
from unittest import mock

import jax.numpy as jnp
import numpy as np
import torch

import tpu2dgs
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs_torch.eval import (capk_probe, fidelity_probe, soak_train, strip_balance_probe,
                                train_bench)
from tpu2dgs_torch.train.loop import TrainConfig

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "scripts"))
import soak_train as jsoak  # noqa: E402
import strip_balance_probe as jstrip  # noqa: E402
import train_bench as jbench  # noqa: E402


class _Stop(Exception):
    """Raised by the recording Trainer: the script ran up to training."""


def _run_script(module, argv, trainer=None):
    """Run a script's main with its model init and Trainer recorded (and
    its JAX render, where it has one, returning black images). Returns what
    was recorded: create_from_pcd's and the Trainer's arguments and the
    render calls' arguments. With `trainer`, the recorded Trainer returns
    it and the script runs on; without, the script stops there."""
    seen = {"renders": []}

    def create(points, colors, **kw):
        seen["pcd"] = (np.asarray(points), np.asarray(colors), kw)
        return "model"

    def record_trainer(*args, **kw):
        seen["trainer"] = (args, kw)
        if trainer is None:
            raise _Stop
        return trainer

    def render(cam, st, *args):
        seen["renders"].append((st, args))
        return {"render": jnp.zeros((3, st.height, st.width))}

    patches = [mock.patch.object(sys, "argv", ["script", *argv]),
               mock.patch.object(tpu2dgs, "enable_compilation_cache", lambda: None),
               mock.patch.object(module.splats_lib, "create_from_pcd", create),
               mock.patch.object(module, "Trainer", record_trainer)]
    if hasattr(module, "render"):
        patches.append(mock.patch.object(module, "render", render))
    for p in patches:
        p.start()
    try:
        module.main()
    except _Stop:
        pass
    finally:
        for p in reversed(patches):
            p.stop()
    return seen


def _same_camera(jc, tc):
    for field in ("uid", "image_name", "width", "height", "fovx", "fovy"):
        assert getattr(jc, field) == getattr(tc, field), field
    for field in ("R", "T", "world_view", "full_proj"):
        np.testing.assert_array_equal(np.asarray(getattr(tc, field)),
                                      np.asarray(getattr(jc, field)), err_msg=field)


def test_scenes_and_configs_match_scripts():
    """train_bench's 24 views with their random images and its shell
    points; soak_train's ground truth (band 0 of its features at atol
    1e-7), its 40 views, its start points; both TrainConfigs and Trainer
    settings: the scripts', from the same default_rng(0)."""
    w, n = 16, 1 << 8
    seen = _run_script(jbench, ["3", str(w), "8"])
    cams, pts, cols = train_bench.problem(w, w, n)
    jcams = seen["trainer"][0][1]
    assert len(jcams) == len(cams) == 24
    for jc, tc in zip(jcams, cams):
        _same_camera(jc, tc)
        np.testing.assert_array_equal(tc.image, jc.image)
    np.testing.assert_array_equal(pts, seen["pcd"][0])
    np.testing.assert_array_equal(cols, seen["pcd"][1])
    assert seen["pcd"][2] == {"capacity": n}
    kw = seen["trainer"][1]
    assert dataclasses.asdict(kw["train_cfg"]) == dataclasses.asdict(train_bench.train_config())
    assert {**kw["raster_kwargs"], "backend": "cuda"} == train_bench.RASTER
    assert (kw["max_sh_degree"], kw["scene_extent"], kw["seed"]) == (3, train_bench.RADIUS, 0)

    seen = _run_script(jsoak, ["3000", str(w)])
    rng = np.random.default_rng(0)
    xyz, scaling, rotation, opacity, feats, rgb = soak_train.ground_truth(rng)
    st, gt = seen["renders"][0]
    assert len(seen["renders"]) == soak_train.VIEWS
    assert (st.sh_degree, st.bin_capacity, st.tile_capacity) == (0, 8192, 2048)
    for a, b in zip((xyz, scaling, rotation, opacity), gt):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_allclose(feats, np.asarray(gt[4]), rtol=0, atol=1e-7)
    pts, cols = soak_train.start_points(rng, xyz, rgb)
    np.testing.assert_array_equal(pts, seen["pcd"][0])
    np.testing.assert_array_equal(cols, seen["pcd"][1])
    assert seen["pcd"][2] == {"capacity": soak_train.CAPACITY}
    args, kw = seen["trainer"]
    for i, jc in enumerate(args[1]):
        _same_camera(jc, train_bench.orbit(i, soak_train.VIEWS, soak_train.RADIUS, w, w))
    assert dataclasses.asdict(kw["train_cfg"]) == dataclasses.asdict(soak_train.train_config(3000))
    assert kw["max_capacity"] == soak_train.MAX_CAPACITY and kw["max_sh_degree"] == 0
    assert {**kw["raster_kwargs"], "backend": "cuda"} == {**soak_train.RASTER,
                                                          "grad_pack_capacity": 0}


class _FakeTrainer:
    """Stands in for the JAX Trainer of soak_train: trains nothing, renders
    black."""

    def __init__(self, w):
        self.model = types.SimpleNamespace(num_live=lambda: 0, capacity=16384)
        self.w = w
        self.steps = []

    def train(self, num_iters):
        self.steps.append(num_iters)

    def render_view(self, cam):
        return {"render": jnp.zeros((3, self.w, self.w)), "tile_overflow_frac": 0.0}


def test_soak_train_short_run(capsys):
    """The port's soak at 16x16 on a cut scene: every chunk reported,
    finite, the steps counted as taken. The script counts a whole chunk of
    500 for a 3-step run (scripts/soak_train.py:109)."""
    res, tr = soak_train.run(3, 16, "cpu", n_gt=1000, n_init=200, capacity=512, views=4)
    assert res["iters"] == 3 == tr.step and [c["step"] for c in res["chunks"]] == [3]
    assert np.isfinite([res["psnr4_start"], res["psnr4_end"], res["it_per_s"]]).all()
    assert res["live"] == 200 and res["capacity"] == 512
    assert set(res["chunks"][0]["overflow"]) == set(soak_train.OVERFLOW)
    for p in tr.model.params:
        assert torch.isfinite(p).all()

    fake = _FakeTrainer(16)
    capsys.readouterr()
    _run_script(jsoak, ["3", "16"], trainer=fake)
    printed = capsys.readouterr().out
    assert fake.steps == [3] and "[500]" in printed and "[3]" not in printed


def test_train_bench_short_run():
    """The port's train_bench at 16x16 with 2^8 splats: the settle loop
    (its passes shortened by a densification interval of 2), then 3 timed
    steps with no growth event."""
    res = train_bench.run(3, 16, 1 << 8, "cpu", interval=2)
    assert res["iters"] == 3 and res["settle_iters"] == 14
    assert res["cap_growth_events"] == [] and np.isfinite(res["it_per_s"])
    assert res["raster_kwargs"] == train_bench.RASTER and res["device"] == "cpu"
    assert TrainConfig().densification_interval == 100  # the script's interval


def test_fidelity_probe_exact_render():
    """fidelity_probe at 32x32: the exact render overflows nowhere (the
    probe raises otherwise), every truncated render is scored."""
    res = fidelity_probe.main(["32", "8"], device="cpu")
    for name in ("bench-pileup", "shell"):
        scene = res["scenes"][name]
        assert set(scene["exact_overflow"].values()) == {0.0}
        assert [r["tile_capacity"] for r in scene["truncated"]] == [1024, 1792, 2048]
        assert scene["demand"]["tile"] > 0


def test_capk_equal_count_pair_bit_equal():
    """capk_probe on the plain versions at a cut size (tile capacity 256,
    capacities 128, 256, 512): the padded lists walk zero records past the
    real ones and stay finite, and capacity 512 at capacity 256's counts
    gives K2's output and K3's rows bit for bit."""
    res = capk_probe.run("cpu", 32, 32, 1024, tile_cap=256, capks=(128, 256, 512),
                         pack_cap=1024)
    assert res["base_capk"] == 256 and res["equal_counts"]["bit_equal"]
    rec3, raw, nty = capk_probe.lists("cpu", 32, 32, 1024, tile_cap=256)
    assert int(raw.max()) > 256  # the padded capacity walks zero records
    lo = torch.clamp(raw, max=256).to(torch.int32)
    out_a, rows_a, _ = capk_probe.blend_both(capk_probe.at_capk(rec3, 256), lo, nty, 1024)
    out_b, rows_b, _ = capk_probe.blend_both(capk_probe.at_capk(rec3, 512), lo, nty, 1024)
    assert capk_probe.bits_equal(out_a, out_b) and capk_probe.bits_equal(rows_a, rows_b)
    out_c, rows_c, _ = capk_probe.blend_both(capk_probe.at_capk(rec3, 512),
                                             torch.clamp(raw, max=512).to(torch.int32), nty, 1024)
    assert torch.isfinite(out_c).all() and torch.isfinite(rows_c).all()
    assert [r["walked_entries"] for r in res["capks"]] == [
        capk_probe.walked(torch.clamp(raw, max=c)) for c in (128, 256, 512)]


def test_strip_balance_matches_script():
    """imbalance (static and cyclic) and balanced_imbalance on the same
    per-tile counts and boxes: the port's against the script's."""
    rng = np.random.default_rng(5)
    w, nbx, nty, k = 800, 7, 50, 600
    counts = rng.integers(0, 1792, (nbx, nty))
    row_work = counts.sum(axis=0)
    center = rng.uniform(0, 800, (k, 2)).astype(np.float32)
    half = rng.uniform(1, 60, (k, 2)).astype(np.float32)
    visible = rng.uniform(size=k) < 0.9
    jsplats = types.SimpleNamespace(box_center=jnp.asarray(center), box_half=jnp.asarray(half),
                                    visible=jnp.asarray(visible))
    tsplats = types.SimpleNamespace(box_center=torch.from_numpy(center),
                                    box_half=torch.from_numpy(half),
                                    visible=torch.from_numpy(visible))
    for n_dev in (2, 4, 8):
        for cyclic in (False, True):
            jr, jdev = jstrip.imbalance(row_work, nty, n_dev, cyclic)
            tr, tdev = strip_balance_probe.imbalance(row_work, nty, n_dev, cyclic)
            assert tr == jr
            np.testing.assert_array_equal(tdev, jdev)
        jr, jdev = jstrip.balanced_imbalance(jsplats, row_work, w, nty, n_dev)
        tr, tdev = strip_balance_probe.balanced_imbalance(tsplats, row_work, w, nty, n_dev)
        assert tr == jr
        np.testing.assert_array_equal(tdev, jdev)
