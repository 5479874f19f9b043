"""tpu2dgs_torch's viewer against tpu2dgs's: the MiniCam
(make_camera_arrays), the network_gui server over loopback (the JAX server
and the port's get the same client script), the six render modes on one
seeded package, cli.view's request (NetworkGUI.serve) on a seeded PLY, the
Trainer's viewer polling with a pause, and cli.train's viewer branch.

No JAX render or train step is compiled: the render modes are fed the same
precomputed maps, and the frames are the port's own renders (the port's
render parity with JAX is tests/test_torch_render.py's). PyTorch runs on
one thread, as in tests/test_torch_oracle.py."""

import argparse
import json
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from tests.test_torch_threads import jax_compile_cache, one_torch_thread  # noqa: F401  (autouse)
from tpu2dgs.core import cameras as jcam
from tpu2dgs.viewer import modes as jmodes
from tpu2dgs.viewer import network_gui as jgui
from tpu2dgs_torch.cli import config as tcfg
from tpu2dgs_torch.cli import train as tcli_train
from tpu2dgs_torch.cli import view as tcli_view
from tpu2dgs_torch.core import cameras as tcam
from tpu2dgs_torch.eval import synthetic
from tpu2dgs_torch.model import splats as tsplats
from tpu2dgs_torch.raster import api as tapi
from tpu2dgs_torch.train import loop as tloop
from tpu2dgs_torch.viewer import modes as tmodes
from tpu2dgs_torch.viewer import network_gui as tgui

ITEMS = ["RGB", "Alpha", "Normal", "Depth", "Edge", "Curvature"]
CAPS = dict(bin_capacity=256, tile_capacity=256, col_capacity=256)


# -- a viewer client ------------------------------------------------------------


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "the server closed the connection"
        buf += chunk
    return buf


def _read_framed(sock) -> bytes:
    (n,) = struct.unpack("<I", _recv_exact(sock, 4))
    return _recv_exact(sock, n)


def _message(cam, w, h, mode=0, train=True, keep_alive=True, scaling_modifier=1.0):
    """The control message a SIBR client sends for `cam` (a host Camera):
    its matrices with the flips the server undoes."""
    view = cam.world_view.copy()
    view[:, 1:3] *= -1
    proj = np.array(cam.full_proj, np.float32)
    proj[:, 1] *= -1
    return {"resolution_x": w, "resolution_y": h, "train": train, "fov_y": cam.fovy,
            "fov_x": cam.fovx, "z_near": cam.znear, "z_far": cam.zfar,
            "keep_alive": keep_alive, "scaling_modifier": scaling_modifier,
            "shs_python": False, "rot_scale_python": False,
            "view_matrix": [float(v) for v in view.flatten()],
            "view_projection_matrix": [float(v) for v in proj.flatten()],
            "render_mode": mode}


def _request(sock, msg) -> tuple:
    """Send one message (a dict, or the raw bytes of a malformed one, which
    gets no image); read (image bytes or None, verify, metrics)."""
    raw = isinstance(msg, bytes)
    payload = msg if raw else json.dumps(msg).encode()
    sock.sendall(struct.pack("<I", len(payload)) + payload)
    n = 0 if raw else msg["resolution_x"] * msg["resolution_y"] * 3
    image = _recv_exact(sock, n) if n else None
    return image, _read_framed(sock).decode("ascii"), json.loads(_read_framed(sock))


def _client(port, messages, out, before=None):
    """A client thread: connect, read the render items, send `messages`
    in turn (calling before(i) ahead of message i, if given); out["items"],
    out["replies"], and out["error"] if it failed."""
    def run():
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
                out["items"] = json.loads(_read_framed(s))
                out["replies"] = []
                for i, msg in enumerate(messages):
                    if before is not None:
                        before(i)
                    out["replies"].append(_request(s, msg))
        except Exception as e:  # reported by the test thread
            out["error"] = repr(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _accept(gui, items=None, timeout=30.0):
    t0 = time.monotonic()
    while gui.conn is None:
        assert time.monotonic() - t0 < timeout, "no client connected"
        gui.try_connect(items)
        time.sleep(0.001)


def _orbit(w, h, a=0.7):
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    kw = dict(uid=0, image_name="o", R=R, T=np.array([0.3, -0.2, 2.5]), fovx=1.1, fovy=0.8,
              width=w, height=h)
    return jcam.Camera(**kw), tcam.Camera(**kw)


# -- the tests ------------------------------------------------------------------


def test_make_camera_arrays_matches_jax():
    jc, _ = _orbit(40, 24)
    got = tcam.make_camera_arrays(jc.world_view, 0.05, 50.0, 1.1, 0.8, device="cpu")
    want = jcam.make_camera_arrays(jc.world_view, 0.05, 50.0, 1.1, 0.8)
    for name, a, b in zip(want._fields, got, want):
        assert a.dtype == torch.float32 and a.device.type == "cpu", name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6, err_msg=name)
    with pytest.raises(RuntimeError, match="CUDA"):  # no GPU here: no fallback
        tcam.make_camera_arrays(jc.world_view)


def test_network_gui_matches_jax_server():
    """The same client script against the JAX server and the port's: the
    same bytes reach the client, and the port's cameras are bit-equal to
    the JAX server's. Malformed messages, which stop the JAX server, get
    the port's no-camera reply and keep the connection."""
    w, h = 12, 8
    jc, _ = _orbit(w, h)
    messages = [_message(jc, w, h, mode=2, keep_alive=False, scaling_modifier=0.5),
                {**_message(jc, w, h), "resolution_x": 0},   # no camera: no image
                _message(jc, w, h, train=False)]
    rng = np.random.default_rng(0)
    img = rng.uniform(-0.2, 1.2, (3, h, w)).astype(np.float32)
    img[0, 0, :3] = [1.0 / 255.0, 254.5 / 255.0, 0.5]  # near the u8 steps

    def serve(mod, gui, messages=messages):
        gui.init()
        out = {}
        t = _client(gui.listener.getsockname()[1], messages, out)
        _accept(gui, ["RGB", "Normal", "Depth"])
        got = []
        for _ in messages:
            got.append(gui.receive())
            image = None if got[-1][0] is None else mod.image_to_bytes(img)
            gui.send(image, "verify-str", {"#": 42, "loss": 0.25})
        t.join(timeout=30)
        gui.disconnect()
        gui.listener.close()
        assert not t.is_alive() and "error" not in out, out.get("error")
        return got, out

    jgot, jout = serve(jgui, jgui.NetworkGUI("127.0.0.1", 0))
    tgot, tout = serve(tgui, tgui.NetworkGUI("127.0.0.1", 0, device="cpu"))
    assert tout == jout and tout["items"] == ["RGB", "Normal", "Depth"]
    assert [r[0] is None for r in tout["replies"]] == [False, True, False]
    want = (np.clip(img, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0).tobytes()
    assert tout["replies"][0][0] == want  # truncated, not rounded
    for j, t in zip(jgot, tgot):
        assert j[1:] == t[1:]  # (w, h), do_training, keep_alive, scaling_modifier, mode
        if j[0] is None:
            assert t[0] is None
            continue
        for name, a, b in zip(j[0]._fields, t[0], j[0]):
            b = np.asarray(b)
            assert a.dtype == torch.float32 and a.shape == b.shape, name
            np.testing.assert_array_equal(a.numpy().view(np.int32), b.view(np.int32),
                                          err_msg=name)

    good = messages[2]
    bad = [b"{not json", b"\xff", json.dumps([1, 2]).encode(),
           json.dumps({k: v for k, v in good.items() if k != "resolution_x"}).encode(),
           json.dumps({**good, "resolution_y": "eight"}).encode(),
           json.dumps({**good, "resolution_x": -12}).encode(),
           json.dumps({**good, "render_mode": 3}).encode(),  # three items were sent
           json.dumps({k: v for k, v in good.items() if k != "view_matrix"}).encode()]
    tgot, tout = serve(tgui, tgui.NetworkGUI("127.0.0.1", 0, device="cpu"), [*bad, good])
    assert [r[0] is None for r in tgot] == [True] * len(bad) + [False]
    assert all(r[1:] == ((0, 0), None, None, None, None) for r in tgot[:-1])
    assert [r[0] is None for r in tout["replies"]] == [True] * len(bad) + [False]


def test_render_modes_match_jax():
    """All six modes on one seeded 24x16 package."""
    rng = np.random.default_rng(1)
    h, w = 16, 24
    normal = rng.normal(size=(3, h, w)).astype(np.float32)
    pkg = {"render": rng.uniform(size=(3, h, w)).astype(np.float32),
           "rend_alpha": rng.uniform(size=(1, h, w)).astype(np.float32),
           "rend_normal": normal / np.linalg.norm(normal, axis=0, keepdims=True),
           "surf_depth": rng.uniform(1.0, 4.0, (1, h, w)).astype(np.float32)}
    tpkg = {k: torch.from_numpy(v) for k, v in pkg.items()}
    table = np.asarray(jmodes._TURBO)
    np.testing.assert_array_equal(tmodes._TURBO, table)

    def index(rgb):  # each pixel's entry of the turbo table
        d = ((rgb.reshape(3, -1).T[:, None, :] - table[None]) ** 2).sum(-1)
        assert d.min(axis=1).max() == 0.0  # every pixel is a table entry
        return d.argmin(axis=1)

    for img in (pkg["render"], (pkg["rend_normal"] + 1.0) / 2.0):
        np.testing.assert_allclose(tmodes.gradient_map(torch.from_numpy(img)).numpy(),
                                   np.asarray(jmodes.gradient_map(img)), rtol=1e-5, atol=1e-5)
    for mode, item in enumerate(ITEMS):
        got = tmodes.render_net_image(tpkg, ITEMS, mode).numpy()
        want = np.asarray(jmodes.render_net_image(pkg, ITEMS, mode))
        assert got.shape == want.shape == (3, h, w), item
        if item in ("RGB", "Normal"):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=item)
            continue
        ti, ji = index(got), index(want)
        off = ti != ji
        assert off.mean() <= 0.005, (item, int(off.sum()))
        assert np.all(np.abs(ti - ji) <= 1), item


def test_view_serves_one_request(tmp_path):
    """cli.view's request, `NetworkGUI.serve` with the loaded model's
    `ModelView.render`, on a seeded PLY through the plain versions: every
    mode's bytes equal the port's own render -> mode -> bytes for the same
    camera, at the capacities the view ended at (CAPS cut this scene's
    lists: its renders heal them); a zero resolution gets no image."""
    w, h = 32, 24
    _, scene = synthetic.make_shell_scene(w, h, 512, device="cpu")
    it_dir = tmp_path / "point_cloud" / "iteration_7"
    it_dir.mkdir(parents=True)
    tsplats.save_ply(synthetic.scene_model(scene), str(it_dir / "point_cloud.ply"))
    tcfg.save_cfg_args(str(tmp_path), argparse.Namespace(
        source_path="/data/shell", model_path=str(tmp_path), sh_degree=3))
    caps = [f"--{k}={v}" for k, v in CAPS.items()]
    view, args = tcli_view.open_model(["-m", str(tmp_path), *caps], device="cpu")
    assert args.port == 6009 and view.verify == "/data/shell" and view.metrics == {"#": 512}

    cams = [synthetic.shell_camera(2 * np.pi * (0.13 + k / 8), w, h) for k in range(6)]
    cams += [cams[0], cams[0]]
    messages = [_message(c, w, h, mode=m) for m, c in enumerate(cams[:6])]
    messages.append({**messages[0], "resolution_x": 0})
    messages.append(_message(cams[0], w, h, scaling_modifier=0.5))
    gui = tgui.NetworkGUI("127.0.0.1", 0, device="cpu")
    gui.init()
    out = {}
    t = _client(gui.listener.getsockname()[1], messages, out)
    _accept(gui, tgui.RENDER_ITEMS)
    for _ in messages:
        gui.serve(view.render, view.verify, view.metrics)
    t.join(timeout=30)
    gui.close()
    assert not t.is_alive() and "error" not in out, out.get("error")
    assert out["items"] == ITEMS

    model = tsplats.load_ply(str(it_dir / "point_cloud.ply"), device="cpu")
    p = model.params
    args = (p.xyz, torch.exp(p.scaling), p.rotation, torch.sigmoid(p.opacity[:, 0]),
            tsplats.features(p))
    for cam, msg, (image, verify, metrics) in zip(cams, messages, out["replies"]):
        assert verify == "/data/shell" and metrics == {"#": 512}
        if msg["resolution_x"] == 0:
            assert image is None
            continue
        settings = tapi.RasterSettings(w, h, scale_modifier=msg["scaling_modifier"],
                                       **{k: view.settings[k] for k in CAPS})
        with torch.no_grad():
            pkg = tapi.render(cam.arrays("cpu"), settings, *args, torch.zeros(3),
                              live=model.live, device="cpu")
        want = tgui.image_to_bytes(tmodes.render_net_image(pkg, ITEMS, msg["render_mode"]))
        assert image == want, ITEMS[msg["render_mode"]]
    assert out["replies"][0][0] != out["replies"][-1][0]  # the scaling modifier is applied
    assert view.healer.rerenders > 0 and view.healer.events[0][0] == "view 0"


def test_trainer_serves_frames_and_pauses():
    """A client connected to Trainer(gui=) gets frames mid-training, the
    run is not stalled, and a pause (do_training=False) holds the step
    still until the client resumes (as tests/test_viewer.py holds the JAX
    Trainer). A viewer under a mesh is refused in tests/test_torch_train.py."""
    w = h = 32
    cams, model = synthetic.make_shell_training_set(w, h, 300, views=3, device="cpu", **CAPS)
    gui = tgui.NetworkGUI("127.0.0.1", 0, device="cpu")
    gui.init()
    trainer = tloop.Trainer(model, cams, w, h, 1.0, 3.0, gui=gui, max_sh_degree=0,
                            raster_kwargs=dict(CAPS, backend="tiled"))  # the fast plain one
    trainer.source_path = "/data/test"

    frozen = []

    def before(i):
        if i == 2:  # the reply to message 1 (a pause) is in: the loop waits now
            s0 = trainer.step
            time.sleep(0.7)
            frozen.append((s0, trainer.step))

    messages = [_message(cams[0], 16, 16), _message(cams[1], 16, 16, mode=1, train=False),
                _message(cams[2], 16, 16)]
    out = {}
    t = _client(gui.listener.getsockname()[1], messages, out, before)
    trainer.train(num_iters=40)
    t.join(timeout=30)
    gui.close()
    assert not t.is_alive() and "error" not in out, out.get("error")
    assert trainer.step == 40  # resumed and finished
    assert frozen and frozen[0][0] == frozen[0][1] < 40, frozen
    assert out["items"] == ITEMS and len(out["replies"]) == 3
    for image, verify, metrics in out["replies"]:
        assert len(image) == 16 * 16 * 3 and verify == "/data/test"
        assert metrics["#"] == 300 and np.isfinite(metrics["loss"]) and metrics["loss"] > 0


def test_cli_train_opens_the_viewer(tmp_path, capsys):
    """cli.train without --disable_viewer hands the Trainer a listening GUI
    (closed when the run ends); where the port is taken it says so and
    trains without one."""
    from tests.test_data import _make_colmap_dataset

    scene = tmp_path / "scene"
    scene.mkdir()
    _make_colmap_dataset(str(scene), n_views=6, n_pts=40)
    base = ["-s", str(scene), "--iterations", "1", "--quiet", "--backend", "tiled"]
    trainer = tcli_train.main([*base, "-m", str(tmp_path / "a"), "--port", "0"], device="cpu")
    assert trainer.step == 1 and isinstance(trainer.gui, tgui.NetworkGUI)
    assert trainer.source_path == str(scene) and trainer.gui.listener is None  # closed
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        port = str(taken.getsockname()[1])
        trainer = tcli_train.main([*base, "-m", str(tmp_path / "b"), "--port", port],
                                  device="cpu")
    assert trainer.step == 1 and trainer.gui is None
    assert "viewer server unavailable" in capsys.readouterr().out
