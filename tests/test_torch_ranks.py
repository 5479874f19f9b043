"""The viewer over ranks and the collective probe of the port, on two gloo
ranks on the CPU (one spawn for all the rank work; the ranks run functions
of parallel/rehearsal.py):

  * eval.collective_probe's splat settings against the JAX script
    (scripts/collective_probe.py): its `collective_bytes` of JAX's
    compiled splat-sharded gradient on make_mesh(2) of the conftest's
    virtual devices, all-gather and routed, kind by kind, up to the
    differences named below, which the test computes from the shapes;
  * its row settings against the port's own formula: the splat-gradient
    all-reduce of `sharded._Replicated` and the row gather;
  * Trainer(mesh=, gui=) under tile rows and under splat sharding: a
    client thread in rank 0's process pauses training, asks for frames in
    several modes (and once for none), holds the pause past several
    heartbeats and resumes; every frame's bytes equal the one-device frame
    of the same state (gathered under splat sharding), "#" is the whole
    model's count, and the pause holds every rank's step;
  * cli.train --n_devices 2 with the viewer on and no client, and with its
    port taken, against --disable_viewer.

Where the port's bytes differ from JAX's, by design:

  * the merge channels: the port carries each survivor's depth and its
    two packed boxes as float64 (24 B a row), JAX depth f32, gid, px and
    py i32 (16 B); in the routed exchange JAX's depth rides the record
    message as a 25th float, so its transposed all-to-all also sends the
    depth's (zero) cotangent back, 4 B a row the port does not send;
  * under work windows the routed exchange all-gathers the packed boxes
    as float64 pairs (16 B a row), JAX as int32 px, py (8 B);
  * JAX all-to-alls each rank's (D,) survivor counts in the routed
    exchange and psums n_vis (4 B) in the all-gather one; the port counts
    the survivors that arrived from their depths;
  * the output: the port returns the image and every map whole on every
    rank (`_GatherRows`, and the counters gathered, both the "assembly"
    part), where JAX's stays row-sharded and its partitioner moves only
    what the loss reads (the collectives outside its shard_map).

The 24-float records and their cotangents are equal byte for byte.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_data import _make_colmap_dataset
from tests.test_torch_cli import TRAIN_FLAGS
from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_splat_sharded import _training
from tpu2dgs.eval import synthetic as jsynthetic
from tpu2dgs.parallel.sharded import make_mesh
from tpu2dgs.raster import api as japi
from tpu2dgs_torch.eval import collective_probe, synthetic
from tpu2dgs_torch.parallel import distributed, rehearsal, sharded
from tpu2dgs_torch.raster import cuda_backend as cb
from tpu2dgs_torch.raster import preprocess
from tpu2dgs_torch.train import loop as tloop
from tpu2dgs_torch.viewer import network_gui

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
D = 2
PROBE_W, PROBE_N = 64, 512      # k_loc 256, the routed xfer max(256, 64) = 256
STEPS = 3                       # steps with the viewer on before the client
HEARTBEAT_S, HOLD_S = 0.25, 2.5  # the client holds the pause for ten heartbeats


def _viewer_case():
    """`_training`'s problem with the start model's rows shuffled, so both
    ranks' segments hold live splats, and the client's messages: a pause
    with a frame, frames in other modes (one at another scaling), one
    without a camera, and after HOLD_S the resume."""
    model, cams, w, h, steady, _ = _training()
    perm = np.random.default_rng(7).permutation(len(model["live"]))
    model = {k: v[perm] for k, v in model.items()}

    def msg(i, mode, **kw):
        return rehearsal.viewer_message(cams[i], w, h, mode, **kw)

    messages = [msg(0, 0, train=False), msg(1, 2, train=False, scaling_modifier=0.7),
                dict(msg(1, 0, train=False), resolution_x=0), msg(2, 3, train=False),
                msg(3, 5, keep_alive=False)]
    return model, cams, w, h, steady, messages


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank function in one spawn of two gloo ranks: the probe's four
    settings, the viewer under tile rows and under splat sharding, and
    three cli.train runs (viewer off, on with no client, on a taken port)."""
    model, cams, w, h, steady, messages = _viewer_case()
    root = str(tmp_path_factory.mktemp("ranks") / "scene")
    os.makedirs(root)
    _make_colmap_dataset(root, n_views=6, n_pts=40)  # 64x48, the JAX package's writers
    out = os.path.dirname(root)
    base = ["-s", root, "--n_devices", "2", *(f for f in TRAIN_FLAGS if f != "--disable_viewer")]
    free, taken = distributed.free_port(), distributed.free_port()
    runs = [[*base, "-m", os.path.join(out, "off"), "--disable_viewer"],
            [*base, "-m", os.path.join(out, "on"), "--port", str(free)],
            [*base, "-m", os.path.join(out, "taken"), "--port", str(taken)]]
    cases = collective_probe.settings(PROBE_N, PROBE_W, D)
    viewer = (model, cams, w, h, STEPS)
    calls = [(rehearsal.probe_rank, (PROBE_W, PROBE_N, [s for _, s, _ in cases],
                                     [x for _, _, x in cases])),
             *((rehearsal.viewer_rank, (*viewer, dict(steady, shard_splats=split), messages,
                                        HEARTBEAT_S, HOLD_S)) for split in (False, True)),
             (rehearsal.cli_viewer_rank, (runs, taken))]
    got = distributed.spawn(rehearsal.each, D, args=(calls,), device="cpu", timeout_s=600)
    probe, rows, splats, cli = zip(*got)
    return {"probe": probe, "rows": rows, "splats": splats, "cli": cli, "model": model,
            "messages": messages}


def _script():
    """scripts/collective_probe.py, loaded by path (its main is not run)."""
    spec = importlib.util.spec_from_file_location(
        "collective_probe_script", os.path.join(ROOT, "scripts", "collective_probe.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_bytes(script, xfer):
    """The script's measure() of JAX's splat-sharded gradient at the test's
    shape, lowered and compiled only: `collective_bytes` of the collectives
    inside the shard_map and of those outside it, with the port's names."""
    cam, scene = jsynthetic.make_bench_scene(PROBE_W, PROBE_W, PROBE_N)
    mesh = make_mesh(D)
    settings = japi.RasterSettings(width=PROBE_W, height=PROBE_W, sh_degree=3, backend="pallas",
                                   debug=True, xfer_capacity=xfer, **collective_probe.CAPS)
    bg = jnp.zeros(3, jnp.float32)

    def loss(xyz, scaling, rotation, opacity, features):
        out = japi.render(cam, settings, xyz, scaling, rotation, opacity, features, bg,
                          mesh=mesh, shard_splats=True)
        return jnp.sum(out["render"] ** 2) + jnp.sum(out["rend_dist"])

    lines = (jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4))).lower(*scene).compile()
             .as_text().splitlines())

    def count(keep):
        got = script.collective_bytes("\n".join(line for line in lines if keep(line)))
        return {k.replace("-", "_"): v for k, v in got.items()}

    return count(lambda line: "/shard_map/" in line), count(lambda line: "/shard_map/" not in line)


def _plus(a, b):
    keys = set(a) | set(b)
    return {k: a.get(k, 0) + b.get(k, 0) for k in keys if a.get(k, 0) + b.get(k, 0)}


def test_probe_splat_bytes_match_jax_script(ranks):
    script = _script()
    k_loc = PROBE_N // D
    cases = collective_probe.settings(PROBE_N, PROBE_W, D)
    kx = cases[1][1].xfer_capacity
    assert kx == max(256, k_loc // 4) == 256
    rec = 24 * 4
    # port minus JAX, per kind, for the named exchange differences
    named = {
        0: {"all_gather": D * k_loc * (3 * 8 - (4 + 3 * 4)),  # merge channels
            "all_reduce": -4},                               # JAX's n_vis psum
        1: {"all_gather": D * k_loc * (2 * 8 - 2 * 4),        # the windows' boxes
            "all_to_all": (D * kx * (3 * 8 - (4 + 3 * 4))      # merge channels
                           - D * kx * 4                        # JAX sends depth's cotangent back
                           - D * 4)},                          # JAX's (D,) counts
    }
    for i, xfer in ((0, 0), (1, kx)):
        assert cases[i][1].xfer_capacity == xfer and cases[i][2]
        inside, outside = _jax_bytes(script, xfer)
        for r in ranks["probe"]:
            got = r[i]
            parts = got["parts"]
            assert set(parts) == {"exchange", "assembly"}, parts
            assert parts["exchange"] == _plus(inside, named[i]), (cases[i][0], inside)
            assert got["bytes"] == _plus(parts["exchange"], parts["assembly"])
            assert list(parts["assembly"]) == ["all_gather"] and outside, outside
        # the records and their cotangents, byte for byte: what is left past
        # the port's merge channels (3 float64 a row)
        exchange = ranks["probe"][0][i]["parts"]["exchange"]
        if i == 0:
            assert exchange["all_gather"] - D * k_loc * 24 == D * k_loc * rec
            assert exchange["reduce_scatter"] == k_loc * rec
        else:
            assert exchange["all_to_all"] - D * kx * 24 == 2 * D * kx * rec


def test_probe_row_bytes_match_port_formula(ranks):
    cases = collective_probe.settings(PROBE_N, PROBE_W, D)
    cam, scene = synthetic.make_bench_scene(PROBE_W, PROBE_W, PROBE_N, device=CPU)
    params = [a.clone().requires_grad_(True) for a in scene]
    splats = preprocess.preprocess(*params, cam, PROBE_W, PROBE_W, 3)
    grads = sum(getattr(splats, f).numel() for f in sharded.GRAD_FIELDS
                if getattr(splats, f).requires_grad) * 4
    assert grads == PROBE_N * 16 * 4  # tmat, color, opacity, normal: JAX's psum too
    with torch.no_grad():
        img, allmap = cb.rasterize_cuda(splats, cases[2][1], torch.zeros(3), plain=True)
    stacked, _ = sharded._map_channels(img, allmap)
    channels = stacked.shape[-1]
    counters = sum(k.startswith("_aux_") for k in allmap) + 1  # and _aux_strip_rows
    nty = -(-PROBE_W // cb.BY)
    c, e = splats.box_center.detach(), splats.box_half.detach()
    bnd = sharded._balance_boundaries(c[:, 0] - e[:, 0], c[:, 0] + e[:, 0], c[:, 1] - e[:, 1],
                                      c[:, 1] + e[:, 1], splats.visible, PROBE_W, nty, D,
                                      tile_cap=cases[3][1].tile_capacity).tolist()
    rows = {2: sharded._strip_rows(PROBE_W, cb.BY, cb.CBY, D) * cb.BY,
            3: max(b - a for a, b in zip(bnd, bnd[1:])) * cb.BY}
    width = -(-PROBE_W // cb.BX) * cb.BX
    for i in (2, 3):
        assert not cases[i][2]
        want = {"gradients": {"all_reduce": grads},
                "assembly": {"all_gather": D * (rows[i] * width * channels + counters) * 4}}
        for r in ranks["probe"]:
            assert r[i]["parts"] == want, (cases[i][0], r[i]["parts"], want)
    assert rows[3] < rows[2]  # the windows' rows, not the static strips'


def _frames(result, model, messages, split):
    rank0, rank1 = result
    live = int(np.sum(model["live"]))
    assert rank0["client_error"] is None and not rank0["client_alive"]
    assert rank0["items"] == network_gui.RENDER_ITEMS
    assert rank0["num_live"] == live
    assert len(rank0["replies"]) == len(messages)
    for msg, reply in zip(messages, rank0["replies"]):
        assert reply["verify"] == "ranks" and reply["metrics"]["#"] == live, reply
        assert np.isfinite(reply["metrics"]["loss"]) and reply["metrics"]["loss"] > 0
        assert reply["image"] == bool(msg["resolution_x"])
        if reply["image"]:
            assert reply["bytes_equal"], msg["render_mode"]
    asked = sum(bool(m["resolution_x"]) for m in messages)
    assert len(rank0["frame_launches"]) == asked
    # under splat sharding every rank renders every frame with rank 0
    assert len(rank1["frame_launches"]) == (asked if split else 0)
    codes = [c for _, c in rank1["words"]]
    assert codes.count(tloop.GUI_FRAME) == (asked if split else 0)
    for r in result:
        assert len(r["idle_word_seconds"]) == STEPS  # one word a step while nobody watches
        assert r["idle_bytes"]["viewer"] == {"broadcast": STEPS * network_gui.WORD_LEN * 8}
        # an idle word is read for its code alone: no camera is built and
        # moved to the device (only a frame's request is read, then rendered)
        assert r["idle_requests_read"] == 0
        assert r["step"] == STEPS + 1 and len(r["step_launches"]) == STEPS + 1


def test_frames_over_tile_rows_equal_one_device(ranks):
    _frames(ranks["rows"], ranks["model"], ranks["messages"], split=False)


def test_frames_over_splat_sharding_equal_one_device(ranks):
    model = ranks["model"]
    _frames(ranks["splats"], model, ranks["messages"], split=True)
    half = len(model["live"]) // D
    assert 0 < int(np.sum(model["live"][:half])) < int(np.sum(model["live"]))  # "#" sums


def test_pause_holds_every_rank_past_heartbeats(ranks):
    for result in (ranks["rows"], ranks["splats"]):
        for r in result:
            codes = [c for _, c in r["words"]]
            assert codes[-1] == tloop.GUI_RESUME and codes.count(tloop.GUI_RESUME) == 1
            # heartbeats, more than one, while the client holds the pause
            paused = [k for k, c in enumerate(codes) if c == tloop.GUI_PAUSED]
            assert len(paused) >= 2, codes
            # the pause held the step (one step was asked for) past HOLD_S
            assert r["served_seconds"] >= HOLD_S and r["step"] == STEPS + 1
            times = [t for t, _ in r["words"]]
            assert max(b - a for a, b in zip(times, times[1:])) < 50 * HEARTBEAT_S
        # rank 0 tells "still paused" no sooner than a heartbeat after its last word
        times = [t for t, _ in result[0]["words"]]
        codes = [c for _, c in result[0]["words"]]
        assert all(times[k] - times[k - 1] >= HEARTBEAT_S
                   for k, c in enumerate(codes) if c == tloop.GUI_PAUSED and k)


def test_cli_train_viewer_over_ranks_trains_alike(ranks):
    for rank, (off, on, taken) in enumerate(ranks["cli"]):
        assert off["steps"] == on["steps"] == taken["steps"] == 6
        assert off["loss"] == on["loss"] == taken["loss"]  # bit-equal steps
        assert np.all(np.isfinite(off["loss"]))
        assert off["viewer"] is None and taken["viewer"] is None
        assert on["viewer"] == ("NetworkGUI" if rank == 0 else "Follower")
    # the control word carries a request exactly
    cam = synthetic.shell_camera(0.4, 96, 64).arrays(CPU)
    word = network_gui.request_word(tloop.GUI_FRAME, cam, 96, 64, 0.7)
    got, w, h, sm = network_gui.read_request(word)
    assert (int(word[0]), w, h, sm) == (tloop.GUI_FRAME, 96, 64, 0.7)
    assert all(torch.equal(a, b) for a, b in zip(got, cam))
