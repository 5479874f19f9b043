"""What a rank of a multi-device run does, as functions `distributed.spawn`
can start: a sharded render with its gradients, a few Trainer steps, with
tile rows or splats split over the ranks, the Trainer serving a viewer
client from rank 0, and the collective probe's step. The CPU tests run
them on gloo ranks, and `chip_smoke.py` on ranks sharing one GPU; each is
held against the same work on one device.

Inputs and results are host data (numpy arrays, cameras, settings), since
they are pickled between the processes.
"""

from __future__ import annotations

import contextlib
import gc
import json
import socket
import struct
import threading
import time
from collections import Counter
from unittest import mock

import numpy as np
import torch

from tpu2dgs_torch.model import densify as densify_lib
from tpu2dgs_torch.native import build as native
from tpu2dgs_torch.parallel import distributed, sharded
from tpu2dgs_torch.raster import api

# The render keys a sharded render is held to, as tests/test_tiled.py's KEYS.
KEYS = ("render", "rend_alpha", "rend_normal", "rend_dist", "surf_depth", "surf_normal",
        "depth_median")
PARAMS = ("xyz", "scaling", "rotation", "opacity", "features")


def each(mesh, calls):
    """Several rank functions in turn on one group (one spawn for all):
    [fn(mesh, *args) for fn, args in calls]."""
    return [fn(mesh, *args) for fn, args in calls]


def loss_of(out: dict) -> torch.Tensor:
    """A loss that reaches every map a training loss reads (the one of
    tests/test_sharded.py's gradient test)."""
    return (torch.sum(out["render"] ** 2) + torch.sum(out["rend_dist"])
            + 0.1 * torch.sum(out["rend_normal"] * out["surf_normal"]))


def render_once(cam, settings, scene, bg, device, mesh=None, plain=False,
                shard_splats=False):
    """Render `scene` (numpy xyz, scaling, rotation, opacity, features) from
    `cam` (a core.cameras.Camera) on `device`, on one device or over
    `mesh` (with `shard_splats`, from this rank's rows of the scene), and
    the gradients of `loss_of` for every parameter. Returns numpy arrays:
    the KEYS, the counters of the output dict and "grad_<param>" (this
    rank's rows when the splats are sharded), plus "launches", the kernel
    launches it made, and "seconds": host seconds of the render and of its
    gradients, each ending in a synchronize."""
    if shard_splats:  # this rank's rows: rank*N/D .. (rank+1)*N/D
        per = len(scene[0]) // mesh.size
        scene = [np.asarray(a)[mesh.rank * per:(mesh.rank + 1) * per] for a in scene]
    params = [torch.tensor(np.asarray(a), device=device, requires_grad=True) for a in scene]
    native.LAUNCHES.clear()
    sync = _sync(device)
    t0 = time.perf_counter()
    out = api.render(cam.arrays(device), settings, *params,
                     torch.tensor(np.asarray(bg), device=device), mesh=mesh,
                     shard_splats=shard_splats, device=device, plain=plain)
    sync()
    t1 = time.perf_counter()
    gs = torch.autograd.grad(loss_of(out), params)
    sync()
    seconds = {"render": t1 - t0, "gradients": time.perf_counter() - t1}
    res = {k: v.detach().cpu().numpy() for k, v in out.items() if torch.is_tensor(v)}
    res.update({f"grad_{k}": g.cpu().numpy() for k, g in zip(PARAMS, gs)})
    res["launches"] = dict(native.LAUNCHES)
    res["seconds"] = seconds
    return res


def _sync(device):
    return torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)


def render_rank(mesh, cam, settings_seq, scene, bg, plain=False, shard_splats=False):
    """`render_once` over `mesh` on this rank's device, for each of the
    RasterSettings of `settings_seq`: a list of results."""
    return [render_once(cam, settings, scene, bg, mesh.device, mesh=mesh, plain=plain,
                        shard_splats=shard_splats)
            for settings in settings_seq]


def model_arrays(model) -> dict:
    """A SplatModel as host arrays: its parameters and its live mask."""
    out = {k: v.detach().cpu().numpy() for k, v in model.params._asdict().items()}
    out["live"] = model.live.cpu().numpy()
    return out


def state_rows(trainer) -> tuple[list[int], int]:
    """The row counts of every per-splat tensor the Trainer keeps on this
    rank (its parameters, live mask, statistics and Adam moments), and
    their bytes."""
    m, adam = trainer.model, trainer.adam
    tensors = [*m.params, m.live, m.max_radii2d, m.grad_accum, m.denom, *adam.mu, *adam.nu]
    return (sorted({t.shape[0] for t in tensors}),
            sum(t.numel() * t.element_size() for t in tensors))


def _held_rounds(trainer, log: list) -> None:
    """Hold each densification round of a splat-sharded Trainer, gathered,
    against densify_and_prune(segments=D) of the whole state before it,
    with the same noise, and append what was seen to `log`: on every rank
    the round's counts on that rank ("rank_info"); on rank 0, which holds
    the gathered states (in host memory, where the reference round runs),
    whether the live masks and the Adam moments are bit-equal, the largest
    relative error of a parameter and the whole round's counts."""
    mesh = trainer.mesh
    round_on_rank = trainer._densify_round

    def held(eps, use_size_prune):
        before, adam_before = sharded.gather_model_state(trainer.model, trainer.adam, mesh)
        model, adam, info = round_on_rank(eps, use_size_prune)
        got, got_adam = sharded.gather_model_state(model, adam, mesh)
        seen = {"rank_info": [int(v) for v in info]}
        if got is not None:
            want, want_adam, want_info = densify_lib.densify_and_prune(
                trainer.densify_cfg, before, adam_before, None, float(trainer.scene_extent),
                use_size_prune, segments=mesh.size, eps=eps.cpu())
            rel = {k: float(torch.amax(torch.abs(a.detach() - b.detach()))
                            / max(float(torch.amax(torch.abs(b.detach()))), 1e-30))
                   for k, a, b in zip(want.params._fields, got.params, want.params)}
            seen.update({
                "live_equal": bool(torch.equal(got.live, want.live)),
                "adam_equal": all(torch.equal(a, b) for a, b in
                                  zip([*got_adam.mu, *got_adam.nu],
                                      [*want_adam.mu, *want_adam.nu])),
                "params_rel_err": max(rel.values()),
                "num_live": int(want_info.num_live), "num_dropped": int(want_info.num_dropped),
                "num_cloned": int(want_info.num_cloned),
                "num_split": int(want_info.num_split)})
        log.append(seen)
        return model, adam, info

    trainer._densify_round = held


def train_once(model, cameras, width, height, stops, trainer_kwargs, device, mesh=None,
               sh_degree=0):
    """Trainer steps on `device`, on one device or over `mesh`, from
    `model` (`model_arrays` of a SplatModel), at active SH degree
    `sh_degree`, up to each step count of `stops` in turn. Returns the loss
    and the kernel launches of every step, and at each stop the whole
    model's parameters, live count and capacity, the row counts and bytes
    of the rank's tensors, the host ms a step took since the last stop
    (ending in a synchronize) and the device's peak allocated bytes from
    the start of this call (host data). Under splat sharding
    (trainer_kwargs["shard_splats"]) the whole model's parameters and
    live count are rank 0's alone, and every densification round is held
    against the segmented round of the whole state ("rounds")."""
    from tpu2dgs_torch.model import splats as splats_lib
    from tpu2dgs_torch.train.loop import Trainer

    # splat-sharded, the whole model stays in host memory, as cli.train has it
    on = "cpu" if mesh is not None and trainer_kwargs.get("shard_splats") else device
    params = splats_lib.SplatParams(*(torch.tensor(model[k], device=on)
                                      for k in splats_lib.SplatParams._fields))
    start = splats_lib.SplatModel(params, torch.tensor(model["live"], device=on))
    losses, launches, rounds = [], [], []

    def log_fn(it, metrics):
        losses.append(float(metrics["loss"]))
        launches.append(dict(native.LAUNCHES))
        native.LAUNCHES.clear()

    cuda = torch.device(device).type == "cuda"
    if cuda:  # the peak from here: this run's own
        torch.cuda.reset_peak_memory_stats(device)
    trainer = Trainer(start, cameras, width, height, log_fn=log_fn, mesh=mesh,
                      **trainer_kwargs)
    del start
    if trainer.shard_splats:
        _held_rounds(trainer, rounds)
    trainer.active_sh_degree = sh_degree
    native.LAUNCHES.clear()
    sync = _sync(device)
    at = []
    for stop in stops:
        steps = stop - trainer.step
        sync()
        t0 = time.perf_counter()
        trainer.train(num_iters=steps)
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        rows, nbytes = state_rows(trainer)
        peak = torch.cuda.max_memory_allocated(device) if cuda else None
        stop_at = {"step": trainer.step, "capacity": trainer.capacity(), "rows": rows,
                   "state_bytes": nbytes, "ms_per_step": ms, "max_memory_allocated": peak}
        m, _ = trainer.whole_state()
        if m is not None:
            stop_at.update(params=model_arrays(m), num_live=int(m.num_live()))
        del m
        at.append(stop_at)
    return {"loss": losses, "launches": launches, "stops": at, "rounds": rounds,
            "cap_growth_events": list(trainer.cap_growth_events)}


def train_rank(mesh, model, cameras, width, height, stops, trainer_kwargs, sh_degree=0):
    """`train_once` over `mesh` on this rank's device."""
    return train_once(model, cameras, width, height, stops, trainer_kwargs, mesh.device,
                      mesh=mesh, sh_degree=sh_degree)


def train_alone(mesh, model, cameras, width, height, stops, trainer_kwargs, sh_degree=0):
    """`train_once` on this rank's device with no mesh: one device's run in
    a process of its own, like each rank of a sharded run."""
    return train_once(model, cameras, width, height, stops, trainer_kwargs, mesh.device,
                      sh_degree=sh_degree)


def whole_tensors(capacity: int) -> list[tuple]:
    """The shapes of every tensor alive in this process with `capacity`
    rows (the whole model's, under splat sharding)."""
    return sorted(tuple(o.shape) for o in gc.get_objects()
                  if type(o) in (torch.Tensor, torch.nn.Parameter) and o.dim()
                  and o.shape[0] == capacity)


def cli_rank(mesh, runs):
    """`cli.train.main(argv)` for each argv of `runs` in turn, in this
    rank's group and on its device. For each run, before every block of
    training steps and after the run: the step, the whole capacity, the
    rows the rank's Trainer keeps, and `whole_tensors` of the capacity,
    which under splat sharding is empty: no whole model stays referenced
    between the writes."""
    from tpu2dgs_torch.cli import train as cli_train
    from tpu2dgs_torch.train.loop import Trainer

    def seen(trainer):
        gc.collect()  # what is left is referenced
        c = trainer.capacity()
        return {"step": trainer.step, "capacity": c, "rows": trainer.model.capacity,
                "whole": whole_tensors(c)}

    train, out = Trainer.train, []

    def watched(self, *args, **kwargs):
        out[-1].append(seen(self))
        return train(self, *args, **kwargs)

    Trainer.train = watched
    try:
        for argv in runs:
            out.append([])
            trainer = cli_train.main(argv, device=mesh.device)
            out[-1].append(seen(trainer))
            del trainer
    finally:
        Trainer.train = train
    return out


def probe_rank(mesh, w: int, n: int, settings_seq, shard_seq):
    """`eval.collective_probe`'s step on this rank: the bench scene
    (`make_bench_scene(w, w, n)`, this rank's rows of it where the splats
    are sharded), rendered with each RasterSettings of `settings_seq` (the
    splats sharded where `shard_seq` says so), and the gradients of
    sum(render^2) + sum(rend_dist) for every parameter. For each: the
    output bytes of the collectives, by kind and by part, the kernel
    launches of the forward and backward, and the routed exchange's
    counters where it ran (host data)."""
    from tpu2dgs_torch.eval.synthetic import make_bench_scene

    cam, scene = make_bench_scene(w, w, n, device=mesh.device)
    bg = torch.zeros(3, device=mesh.device)
    per = n // mesh.size
    out = []
    for settings, split in zip(settings_seq, shard_seq):
        rows = [a[mesh.rank * per:(mesh.rank + 1) * per] if split else a for a in scene]
        params = [a.clone().requires_grad_(True) for a in rows]
        distributed.reset_bytes()
        native.LAUNCHES.clear()
        got = api.render(cam, settings, *params, bg, mesh=mesh, shard_splats=split,
                         device=mesh.device)
        torch.autograd.grad(torch.sum(got["render"] ** 2) + torch.sum(got["rend_dist"]), params)
        out.append({"bytes": distributed.snapshot_bytes(),
                    "parts": distributed.snapshot_bytes(by_part=True),
                    "launches": dict(native.LAUNCHES),
                    "xfer": {k: float(got[k]) for k in ("xfer_overflow_frac", "xfer_count_max")
                             if k in got}})
    return out


def viewer_message(cam, width: int, height: int, mode: int = 0, train: bool = True,
                   keep_alive: bool = True, scaling_modifier: float = 1.0) -> dict:
    """The control message a remote viewer sends for the host camera `cam`
    (a core.cameras.Camera): its matrices with the axis flips the server
    undoes."""
    view = np.array(cam.world_view, np.float32)
    view[:, 1:3] *= -1
    proj = np.array(cam.full_proj, np.float32)
    proj[:, 1] *= -1
    return {"resolution_x": width, "resolution_y": height, "train": train,
            "fov_y": float(cam.fovy), "fov_x": float(cam.fovx), "z_near": cam.znear,
            "z_far": cam.zfar, "keep_alive": keep_alive, "scaling_modifier": scaling_modifier,
            "shs_python": False, "rot_scale_python": False,
            "view_matrix": view.flatten().tolist(),
            "view_projection_matrix": proj.flatten().tolist(), "render_mode": mode}


class ViewerClient(threading.Thread):
    """A remote viewer on loopback, in a thread: connects, sends `messages`
    in turn (calling before(i) ahead of message i where given) and keeps
    the render items and each reply (image bytes or None, verify string,
    metrics) with the host ms from its request sent to its metrics
    received. `sent` is set once the first message is out, so the server
    reads it at the first poll that accepts the connection. A failure is
    kept in `error`."""

    def __init__(self, port: int, messages: list, before=None, timeout_s: float = 120.0):
        super().__init__(daemon=True)
        self.port, self.messages, self.before = port, messages, before
        self.timeout_s = timeout_s
        self.sent = threading.Event()
        self.items, self.replies, self.ms, self.error = None, [], [], None

    @staticmethod
    def _exact(sock, n: int) -> bytes:
        buf = bytearray(n)
        view, got = memoryview(buf), 0
        while got < n:
            k = sock.recv_into(view[got:])
            if k == 0:
                raise ConnectionError("the server closed the connection")
            got += k
        return bytes(buf)

    def _framed(self, sock) -> bytes:
        (n,) = struct.unpack("<I", self._exact(sock, 4))
        return self._exact(sock, n)

    def run(self) -> None:
        try:
            with socket.create_connection(("127.0.0.1", self.port),
                                          timeout=self.timeout_s) as sock:
                for i, msg in enumerate(self.messages):
                    if self.before is not None:
                        self.before(i)
                    payload = json.dumps(msg).encode()
                    t0 = time.perf_counter()
                    sock.sendall(struct.pack("<I", len(payload)) + payload)
                    if i == 0:
                        self.sent.set()
                        self.items = json.loads(self._framed(sock))
                    n = msg["resolution_x"] * msg["resolution_y"] * 3
                    image = self._exact(sock, n) if n else None
                    verify = self._framed(sock).decode("ascii")
                    metrics = json.loads(self._framed(sock))
                    self.ms.append((time.perf_counter() - t0) * 1e3)
                    self.replies.append((image, verify, metrics))
        except Exception as e:  # noqa: BLE001  (the thread's boundary: the caller reports it)
            self.error = repr(e)
        finally:
            self.sent.set()


@contextlib.contextmanager
def per_call(owner, name: str, log: list, keep=lambda out: None):
    """Patch owner.name so each call appends (the kernel launches it made,
    keep(its result)) to `log`."""
    orig = getattr(owner, name)

    def counted(*args, **kwargs):
        before = Counter(native.LAUNCHES)
        out = orig(*args, **kwargs)
        log.append((dict(Counter(native.LAUNCHES) - before), keep(out)))
        return out

    with mock.patch.object(owner, name, counted):
        yield


def viewer_rank(mesh, model, cameras, width, height, steps, trainer_kwargs, messages,
                heartbeat_s, hold_s, sh_degree=0):
    """Trainer(mesh=, gui=) on this rank, rank 0 serving a client thread of
    its own process: `steps` steps with the viewer on and no client, then
    one step whose poll serves `messages` (the first sent before the step;
    a message with train False pauses training, and the client waits
    `hold_s` before the last one, which resumes it), at a heartbeat of
    `heartbeat_s`. Then the one-device frame of each request from the
    whole state the frames were served from (gathered to rank 0 under
    splat sharding) through the same mode and cut to bytes, on rank 0.

    Returns on every rank: the viewer words of the served step (host
    seconds from its start, code), the host seconds of each word's
    broadcast over the first `steps` steps (one a step), the host seconds
    of the served step, the launches of each training step and each frame
    it rendered, the bytes of its collectives by part and the requests it
    read out of a word (a camera built, to move to the device) over the
    first `steps` steps, and on rank 0 the replies' checks."""
    from tpu2dgs_torch.model import splats as splats_lib
    from tpu2dgs_torch.train import loop
    from tpu2dgs_torch.viewer import modes, network_gui

    loop.GUI_HEARTBEAT_S = heartbeat_s  # this process's
    on = "cpu" if trainer_kwargs.get("shard_splats") else mesh.device
    params = splats_lib.SplatParams(*(torch.tensor(model[k], device=on)
                                      for k in splats_lib.SplatParams._fields))
    start = splats_lib.SplatModel(params, torch.tensor(model["live"], device=on))
    gui = network_gui.NetworkGUI("127.0.0.1", 0, device=mesh.device) if mesh.rank == 0 \
        else network_gui.Follower()
    if mesh.rank == 0:
        gui.init()
    trainer = loop.Trainer(start, cameras, width, height, mesh=mesh, gui=gui, **trainer_kwargs)
    trainer.source_path = "ranks"
    trainer.active_sh_degree = sh_degree
    words, step_launches, frame_launches, frames, reads = [], [], [], [], []
    broadcast, read_request = distributed.broadcast, network_gui.read_request

    def logged(m, t, src=0, part="other"):
        t0 = time.perf_counter()
        out = broadcast(m, t, src, part)
        if part == "viewer":
            words.append((t0, int(out[0]), time.perf_counter() - t0))
        return out

    def read(word):
        reads.append(time.perf_counter())
        return read_request(word)

    render_frame = trainer._render_frame

    def recorded(cam, w, h, sm):
        frames.append((cam, w, h, sm))
        return render_frame(cam, w, h, sm)

    trainer._render_frame = recorded
    sync = _sync(mesh.device)
    client = None
    try:
        with mock.patch.object(distributed, "broadcast", logged), \
                mock.patch.object(network_gui, "read_request", read), \
                per_call(loop, "train_step", step_launches), \
                per_call(trainer, "_render_frame", frame_launches):
            native.LAUNCHES.clear()
            distributed.reset_bytes()
            trainer.train(num_iters=steps)
            idle_bytes = distributed.snapshot_bytes(by_part=True)
            if mesh.rank == 0:
                client = ViewerClient(gui.listener.getsockname()[1], messages,
                                      lambda i: time.sleep(hold_s * (i == len(messages) - 1)))
                client.start()
                client.sent.wait(timeout=client.timeout_s)
            sync()
            t0 = time.perf_counter()
            trainer.train(num_iters=1)
            sync()
            served = (t0, time.perf_counter())
    finally:
        if mesh.rank == 0:
            gui.close()  # a client still waiting gets an error, not a hang
    out = {"words": [(t - served[0], c) for t, c, _ in words if t >= served[0]],
           "idle_word_seconds": [s for t, _, s in words if t < served[0]],
           "served_seconds": served[1] - served[0], "step": trainer.step,
           "step_launches": [n for n, _ in step_launches],
           "frame_launches": [n for n, _ in frame_launches], "idle_bytes": idle_bytes,
           "idle_requests_read": sum(t < served[0] for t in reads)}
    whole, _ = trainer.whole_state()  # gathered into rank 0's host memory under splat sharding
    if mesh.rank != 0:
        return out
    client.join(timeout=client.timeout_s)
    out.update(client_error=client.error, client_alive=client.is_alive(), items=client.items,
               frame_ms=client.ms, num_live=int(whole.num_live()))
    p = splats_lib.SplatParams(*(a.to(mesh.device) for a in whole.params))
    live = whole.live.to(mesh.device)
    args = (p.xyz, torch.exp(p.scaling), p.rotation, torch.sigmoid(p.opacity[:, 0]),
            splats_lib.features(p))
    checks, served_frames = [], iter(frames)
    for msg, (image, verify, metrics) in zip(messages, client.replies):
        check = {"verify": verify, "metrics": metrics, "image": image is not None}
        if msg["resolution_x"]:
            cam, w, h, sm = next(served_frames)
            settings = api.RasterSettings(width=w, height=h, sh_degree=trainer.active_sh_degree,
                                          scale_modifier=float(sm), **trainer.raster_kwargs)
            with torch.no_grad():
                pkg = api.render(cam, settings, *args, trainer.bg, live=live,
                                 device=mesh.device)
            want = network_gui.image_to_bytes(
                modes.render_net_image(pkg, network_gui.RENDER_ITEMS, msg["render_mode"]))
            check["bytes_equal"] = image == want
        checks.append(check)
    out["replies"] = checks
    return out


def cli_viewer_rank(mesh, runs, hold_port=None):
    """`cli.train.main(argv)` for each argv of `runs` in turn, in this
    rank's group and on its device, rank 0 holding a listening socket on
    `hold_port` (if given) throughout, so a run asked to serve the viewer
    there cannot. For each run: every step's loss and kernel launches, the
    host seconds between one step's end and the next's (the first step's
    wait for the other ranks left out), the steps and host seconds inside
    `Trainer.train` (ending in a synchronize), and the kind of viewer the
    rank trained with."""
    from tpu2dgs_torch.cli import train as cli_train
    from tpu2dgs_torch.train import loop

    holder = None
    if hold_port is not None and mesh.rank == 0:
        holder = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        holder.bind(("127.0.0.1", hold_port))
        holder.listen()
    sync = _sync(mesh.device)
    train, train_step = loop.Trainer.train, loop.train_step
    out = []

    def stepped(*args, **kwargs):
        before = Counter(native.LAUNCHES)
        got = train_step(*args, **kwargs)
        out[-1]["loss"].append(got[2]["loss"])  # read after the run: no wait here
        out[-1]["launches"].append(dict(Counter(native.LAUNCHES) - before))
        out[-1]["step_ends"].append(time.perf_counter())
        return got

    def timed(self, *args, **kwargs):
        sync()
        t0 = time.perf_counter()
        res = train(self, *args, **kwargs)
        sync()
        out[-1]["train_seconds"] += time.perf_counter() - t0
        return res

    try:
        with mock.patch.object(loop.Trainer, "train", timed), \
                mock.patch.object(loop, "train_step", stepped):
            for argv in runs:
                out.append({"loss": [], "launches": [], "step_ends": [], "train_seconds": 0.0})
                trainer = cli_train.main(argv, device=mesh.device)
                gui = trainer.gui
                ends = out[-1].pop("step_ends")
                out[-1].update(loss=[float(x) for x in out[-1]["loss"]], steps=trainer.step,
                               step_seconds=np.diff(ends).tolist(),
                               viewer=None if gui is None else type(gui).__name__)
                del trainer
    finally:
        if holder is not None:
            holder.close()
    return out
