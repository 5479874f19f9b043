"""What a rank of a multi-device run does, as functions `distributed.spawn`
can start: a sharded render with its gradients, and a few Trainer steps,
with tile rows or splats split over the ranks. The CPU tests run them on
gloo ranks, and `chip_smoke.py` on two ranks sharing one GPU; each is held
against the same work on one device.

Inputs and results are host data (numpy arrays, cameras, settings), since
they are pickled between the processes.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from tpu2dgs_torch.model import densify as densify_lib
from tpu2dgs_torch.native import build as native
from tpu2dgs_torch.parallel import sharded
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
