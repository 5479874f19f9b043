"""What a rank of a tile-row run does, as functions `distributed.spawn` can
start: a sharded render with its gradients, and a few Trainer steps. The
CPU tests run them on gloo ranks, and `chip_smoke.py` on two ranks sharing
one GPU; each is held against the same work on one device.

Inputs and results are host data (numpy arrays, cameras, settings), since
they are pickled between the processes.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu2dgs_torch.native import build as native
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


def render_once(cam, settings, scene, bg, device, mesh=None, plain=False):
    """Render `scene` (numpy xyz, scaling, rotation, opacity, features) from
    `cam` (a core.cameras.Camera) on `device`, on one device or over
    `mesh`, and the gradients of `loss_of` for every parameter. Returns numpy arrays: the KEYS, the counters of the output
    dict and "grad_<param>", plus "launches", the kernel launches it made."""
    params = [torch.tensor(np.asarray(a), device=device, requires_grad=True) for a in scene]
    native.LAUNCHES.clear()
    out = api.render(cam.arrays(device), settings, *params,
                     torch.tensor(np.asarray(bg), device=device), mesh=mesh,
                     device=device, plain=plain)
    res = {k: v.detach().cpu().numpy() for k, v in out.items() if torch.is_tensor(v)}
    gs = torch.autograd.grad(loss_of(out), params)
    res.update({f"grad_{k}": g.cpu().numpy() for k, g in zip(PARAMS, gs)})
    res["launches"] = dict(native.LAUNCHES)
    return res


def render_rank(mesh, cam, settings_seq, scene, bg, plain=False):
    """`render_once` over `mesh` on this rank's device, for each of the
    RasterSettings of `settings_seq`: a list of results."""
    return [render_once(cam, settings, scene, bg, mesh.device, mesh=mesh, plain=plain)
            for settings in settings_seq]


def model_arrays(model) -> dict:
    """A SplatModel as host arrays: its parameters and its live mask."""
    out = {k: v.detach().cpu().numpy() for k, v in model.params._asdict().items()}
    out["live"] = model.live.cpu().numpy()
    return out


def train_once(model, cameras, width, height, stops, trainer_kwargs, device, mesh=None,
               sh_degree=0):
    """Trainer steps on `device`, on one device or over `mesh`, from
    `model` (`model_arrays` of a SplatModel), at active SH degree
    `sh_degree`, up to each step count of `stops` in turn. Returns the loss
    and the kernel launches of every step, and at each stop the parameters,
    the live count and the capacity (host data)."""
    from tpu2dgs_torch.model import splats as splats_lib
    from tpu2dgs_torch.train.loop import Trainer

    params = splats_lib.SplatParams(*(torch.tensor(model[k], device=device)
                                      for k in splats_lib.SplatParams._fields))
    start = splats_lib.SplatModel(params, torch.tensor(model["live"], device=device))
    losses, launches = [], []

    def log_fn(it, metrics):
        losses.append(float(metrics["loss"]))
        launches.append(dict(native.LAUNCHES))
        native.LAUNCHES.clear()

    trainer = Trainer(start, cameras, width, height, log_fn=log_fn, mesh=mesh,
                      **trainer_kwargs)
    trainer.active_sh_degree = sh_degree
    native.LAUNCHES.clear()
    at = []
    for stop in stops:
        trainer.train(num_iters=stop - trainer.step)
        m = trainer.model
        at.append({"step": trainer.step, "params": model_arrays(m),
                   "num_live": int(m.num_live()), "capacity": m.capacity})
    return {"loss": losses, "launches": launches, "stops": at,
            "cap_growth_events": list(trainer.cap_growth_events)}


def train_rank(mesh, model, cameras, width, height, stops, trainer_kwargs, sh_degree=0):
    """`train_once` over `mesh` on this rank's device."""
    return train_once(model, cameras, width, height, stops, trainer_kwargs, mesh.device,
                      mesh=mesh, sh_degree=sh_degree)
