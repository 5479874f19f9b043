"""Renders of a stored model heal their capacities, on the CPU (the
kernels' plain versions), with no JAX: raster/capacity.py's growth rule is
the Trainer's, and cli.render (its exported views and its mesh views) and
cli.view's ModelView render at tight capacity flags what they render at
capacities with room for every list.

The model directory is a 400-splat shell (eval.synthetic) saved with
save_ply beside a four-view COLMAP scene of 64x48 images written with the
port's writers: every splat lies in one 128-pixel screen column, so a
column capacity of 128 cuts the column lists, and the truncated column
lists understate the bin demand.
"""

import argparse
import dataclasses
import os

import numpy as np
import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs_torch.cli import config as tcfg
from tpu2dgs_torch.cli import render as tcli_render
from tpu2dgs_torch.cli import view as tcli_view
from tpu2dgs_torch.core.cameras import fov2focal
from tpu2dgs_torch.data import colmap
from tpu2dgs_torch.data.paths import save_img_u8
from tpu2dgs_torch.eval import synthetic
from tpu2dgs_torch.mesh import extract as textract
from tpu2dgs_torch.model import splats as tsplats
from tpu2dgs_torch.raster import capacity
from tpu2dgs_torch.train import loop as tloop

W, H, N, VIEWS, IT = 64, 48, 400, 4, 5
TIGHT = ["--bin_capacity", "8", "--tile_capacity", "8", "--col_capacity", "128"]
ROOM = ["--bin_capacity", "4096", "--tile_capacity", "4096", "--col_capacity", "4096"]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """The model directory (its cfg_args with --eval: view 0 held out)."""
    root = tmp_path_factory.mktemp("heal")
    scene_dir, model = root / "scene", root / "model"
    cams = [synthetic.shell_camera(2 * np.pi * (0.13 + k / VIEWS), W, H) for k in range(VIEWS)]
    sparse = scene_dir / "sparse" / "0"
    sparse.mkdir(parents=True)
    (scene_dir / "images").mkdir()
    cam0 = cams[0]
    colmap.write_cameras_binary({1: colmap.ColmapCamera(1, "PINHOLE", W, H, np.array([
        fov2focal(cam0.fovx, W), fov2focal(cam0.fovy, H), W / 2.0, H / 2.0]))},
        str(sparse / "cameras.bin"))
    rng = np.random.default_rng(0)
    images = {}
    for i, cam in enumerate(cams):
        name = f"{i:03d}.png"
        save_img_u8(rng.random((H, W, 3)), str(scene_dir / "images" / name))
        images[i + 1] = colmap.ColmapImage(
            i + 1, colmap.rotmat2qvec(cam.R.T), np.asarray(cam.T, np.float64), 1, name,
            np.zeros((0, 2)), np.zeros((0,), np.int64))
    colmap.write_images_binary(images, str(sparse / "images.bin"))
    colmap.write_points3d_binary(rng.normal(size=(8, 3)),
                                 np.zeros((8, 3), np.uint8), str(sparse / "points3D.bin"))

    _, scene = synthetic.make_shell_scene(W, H, N, device="cpu")
    ply = model / "point_cloud" / f"iteration_{IT}" / "point_cloud.ply"
    ply.parent.mkdir(parents=True)
    tsplats.save_ply(synthetic.scene_model(scene), str(ply))
    tcfg.save_cfg_args(str(model), argparse.Namespace(**{
        **dataclasses.asdict(tcfg.ModelParams()), "source_path": str(scene_dir),
        "model_path": str(model), "resolution": 1, "eval": True}))
    return str(model)


def _pngs(model_dir, split):
    from PIL import Image

    base = os.path.join(model_dir, split, f"ours_{IT}", "renders")
    out = []
    for name in sorted(os.listdir(base)):
        with Image.open(os.path.join(base, name)) as im:
            out.append(np.asarray(im))
    return out


def _old_trainer_rule(caps, it, metrics, current, max_caps, events):
    """Trainer._maybe_grow_caps as it stood before the rule moved to
    raster/capacity.py: the reference the shared rule is held to."""
    for key, kwarg in capacity.OVERFLOW_CAP_OF.items():
        v = metrics.get(key)
        if v is None or float(v) <= 0.0:
            continue
        cur = current(kwarg)
        demand = metrics.get(capacity.OVERFLOW_DEMAND_OF[key])
        want = int(float(demand) * 1.25) if demand is not None else int(cur * 1.5)
        new = min(-(-max(want, int(cur * 1.5)) // 128) * 128, max_caps[kwarg])
        if new > cur:
            caps[kwarg] = new
            events.append((it, kwarg, new))


def test_growth_rule_is_the_trainers():
    """A fixed sequence of counters through the Trainer (whose derived
    grad-pack cap reads the tile cap grown before it) and through a plain
    dict of the render caps, as the healer keeps them, gives the caps and
    events of the rule as it stood in the Trainer, bit for bit."""
    _, scene = synthetic.make_shell_scene(48, 32, 64, device="cpu")
    kwargs = dict(backend="cuda", bin_capacity=256, tile_capacity=128)
    trainer = tloop.Trainer(synthetic.scene_model(scene), [synthetic.shell_camera(0.8, 48, 32)],
                            48, 32, 1.0, 1.0, raster_kwargs=kwargs,
                            max_caps={"bin_capacity": 2048})
    sequence = [
        {"tile_overflow_frac": 0.25, "tile_count_max": 700.0, "col_overflow_frac": 0.1,
         "col_count_max": 100.0, "vis_overflow": 1.0, "grad_pack_overflow_frac": 1.0},
        {"bin_overflow_frac": 0.5, "bin_count_max": 1e6, "grad_pack_overflow_frac": 1.0,
         "grad_pack_max": 9000.0},
        {"tile_overflow_frac": 0.5, "bin_overflow_frac": 0.0, "xfer_overflow_frac": 0.1,
         "xfer_count_max": 5000.0},
        {"bin_overflow_frac": 0.5, "bin_count_max": 10.0, "col_overflow_frac": 0.0},
    ]
    render_keys = {k for key, kwarg in capacity.OVERFLOW_CAP_OF.items()
                   if kwarg in capacity.RENDER_CAPS
                   for k in (key, capacity.OVERFLOW_DEMAND_OF[key])}
    caps = {"tile_capacity": 128, "bin_capacity": 256, "col_capacity": 32768}
    ref_caps, ref_events = dict(caps), []
    max_caps = {**capacity.MAX_CAPS, "bin_capacity": 2048}
    for it, metrics in enumerate(sequence, start=1):
        metrics = {k: torch.tensor(v) for k, v in metrics.items()}
        before = dict(trainer.raster_kwargs)
        trainer._maybe_grow_caps(it, metrics)
        grown = dict(trainer.raster_kwargs)
        trainer.raster_kwargs = before  # the old rule from the same state
        _old_trainer_rule(trainer.raster_kwargs, it, metrics, trainer._current_cap,
                          trainer.max_caps, ref_events)
        assert trainer.raster_kwargs == grown, it

        render_metrics = {k: v for k, v in metrics.items() if k in render_keys}
        _old_trainer_rule(ref_caps, it, render_metrics, lambda k: int(ref_caps[k]), max_caps,
                          [])
        capacity.grow_caps(caps, render_metrics, max_caps)
        assert caps == ref_caps, it
    assert trainer.cap_growth_events == ref_events
    assert [kwarg for _, kwarg, _ in ref_events] == [
        "tile_capacity", "col_capacity", "grad_pack_capacity", "bin_capacity",
        "grad_pack_capacity", "tile_capacity", "xfer_capacity"]
    assert trainer.raster_kwargs["bin_capacity"] == 2048  # at its ceiling: step 4 adds nothing


def _rounds(out: str, view: str) -> int:
    return sum(line.startswith(f"{view}: lists overflowed") for line in out.splitlines())


def test_render_heals_in_rounds(model_dir, capsys):
    """cli.render at flags that cut the column, bin and tile lists renders
    the first view again until no counter fires, in more than one round (the
    cut column lists understate the bin demand), and writes the PNGs and
    depth TIFFs it writes at room capacities, byte for byte; it returns the
    caps it ended at, and at room capacities the flags' own."""
    from PIL import Image

    written = {}
    for name, flags in (("tight", TIGHT), ("room", ROOM)):
        caps = tcli_render.main(["-m", model_dir, "--quiet", "--skip_mesh", *flags],
                                device="cpu")
        out = capsys.readouterr().out
        written[name] = caps, out, {split: _pngs(model_dir, split) for split in ("train", "test")}
        vis = os.path.join(model_dir, "train", f"ours_{IT}", "vis")
        for f in sorted(os.listdir(vis)):
            with Image.open(os.path.join(vis, f)) as im:
                written[name][2].setdefault("depth", []).append(np.asarray(im))
    (tight_caps, tight_out, tight), (room_caps, room_out, room) = written["tight"], written["room"]
    first = sorted(os.listdir(os.path.join(os.path.dirname(model_dir), "scene", "images")))[1]
    assert _rounds(tight_out, first.rsplit(".", 1)[0]) >= 2, tight_out
    assert "written truncated" not in tight_out and "overflowed" not in room_out
    assert room_caps == {"tile_capacity": 4096, "bin_capacity": 4096, "col_capacity": 4096}
    assert tight_caps["col_capacity"] > 128 and tight_caps["bin_capacity"] > 8
    assert len(tight["train"]) == VIEWS - 1 and len(tight["test"]) == 1
    for key in ("train", "test", "depth"):
        for a, b in zip(tight[key], room[key], strict=True):
            np.testing.assert_array_equal(a, b)


def test_render_reports_a_view_truncated_at_the_ceiling(model_dir, capsys, monkeypatch):
    """With the tile ceiling at 128, below the held-out view's tile demand,
    cli.render writes the view and says which counter still fires; it does
    not raise. A healer that renders many views past a ceiling, as a viewer
    does, says so once per counter and keeps one count and largest fraction
    per counter."""
    monkeypatch.setitem(capacity.MAX_CAPS, "tile_capacity", 128)
    test_dir = os.path.join(model_dir, "test", f"ours_{IT}")
    caps = tcli_render.main(["-m", model_dir, "--quiet", "--skip_mesh", "--skip_train",
                             "--tile_capacity", "8"], device="cpu")
    out = capsys.readouterr().out
    assert caps["tile_capacity"] == 128
    line = next(line for line in out.splitlines() if line.endswith("written truncated"))
    frac = float(line.split("tile_overflow_frac ")[1].split()[0])
    assert 0.0 < frac <= 1.0 and "tile_capacity 128" in line
    assert f"1 of 1 views written truncated: tile_overflow_frac up to {frac:.6g}" in out
    assert os.listdir(os.path.join(test_dir, "renders")) == ["00000.png"]

    healer = capacity.CapacityHealer({"tile_capacity": 128, "bin_capacity": 8,
                                      "col_capacity": 8})
    for f in (0.25, 0.5, 0.125):
        healer.render(lambda caps: {"tile_overflow_frac": torch.tensor(f),
                                    "tile_count_max": torch.tensor(900.0)})
    out = capsys.readouterr().out
    assert healer.truncated == {"tile_overflow_frac": (3, 0.5)} and healer.rerenders == 0
    assert [line.endswith("written truncated") for line in out.splitlines()] == [True]


def test_view_heals_its_frames(model_dir):
    """cli.view's ModelView at tight flags renders the frame it renders at
    room flags, growing its settings' caps on the first frame only."""
    cam = synthetic.shell_camera(2 * np.pi * 0.13, W, H).arrays("cpu")
    frames = {}
    for name, flags in (("tight", TIGHT), ("room", ROOM)):
        view, _ = tcli_view.open_model(["-m", model_dir, *flags], device="cpu")
        frames[name] = [view.render(cam, W, H, 1.0) for _ in range(2)]
        frames[name + "_rerenders"] = view.healer.rerenders
        frames[name + "_caps"] = {k: view.settings[k] for k in capacity.RENDER_CAPS}
    assert frames["tight_rerenders"] >= 2 and frames["room_rerenders"] == 0
    assert frames["tight_caps"]["col_capacity"] > 128
    for a, b in zip(frames["tight"], frames["room"]):
        for key in ("render", "rend_alpha", "surf_depth", "rend_normal"):
            assert torch.equal(a[key], b[key]), key


def test_mesh_views_heal(model_dir, monkeypatch):
    """cli.render's mesh branch fuses, at tight flags, the depth maps it
    fuses at room flags."""
    depths = {}
    recon = textract.GaussianExtractor.reconstruction

    def keep(self, cameras):
        recon(self, cameras)
        depths[name] = [d.clone() for d in self.depthmaps]

    monkeypatch.setattr(textract.GaussianExtractor, "reconstruction", keep)
    for name, flags in (("tight", TIGHT), ("room", ROOM)):
        tcli_render.main(["-m", model_dir, "--quiet", "--skip_train", "--skip_test",
                          "--mesh_res", "16", *flags], device="cpu")
    assert len(depths["tight"]) == VIEWS - 1
    for a, b in zip(depths["tight"], depths["room"], strict=True):
        assert torch.equal(a, b)
