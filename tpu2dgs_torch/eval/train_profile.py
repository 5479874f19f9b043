"""Where a training step's time goes on the GPU.

    python3 -m tpu2dgs_torch.eval.train_profile

Trains the shell scene of chip_smoke.py at the bench size (800x800,
131,072 splats at SH degree 3, the bench capacities, all three loss terms
on, no densification inside the measured window) and prints one JSON line
with

  * `stages_ms`: host-clock ms of each stage of a step, each ending in a
    torch.cuda.synchronize(), mean over the steps: forward (render), loss,
    backward (autograd as a whole, with the backward blend kernel and the
    index_add_ scatter inside it timed by CUDA events), Adam with the
    learning rates, densification statistics;
  * `launches_per_step`: the hand-written kernels' launches;
  * `profile`: torch.profiler over the same number of unstaged steps
    (Trainer.train): the device's busy time (the sum of its kernels'
    times), the window's wall time, the idle share, the number of kernel
    launches of any kind per step, and the kernels that take the most
    device time;
  * `steps_per_s`: unstaged, unprofiled steps over the host clock.

Needs a CUDA device; the kernels build on first use.
"""

from __future__ import annotations

import json
import time
from unittest import mock

import torch
from torch.profiler import ProfilerActivity, profile

from tpu2dgs_torch.eval import synthetic
from tpu2dgs_torch.model import densify as densify_lib
from tpu2dgs_torch.model import optim as optim_lib
from tpu2dgs_torch.native import build as native
from tpu2dgs_torch.raster import cuda_backend
from tpu2dgs_torch.train import loop

W = H = 800
N_SPLATS = 1 << 17
CAPS = dict(bin_capacity=8192, tile_capacity=2048, col_capacity=32768)
GT_CAPS = dict(bin_capacity=20480, tile_capacity=10240, col_capacity=61440)
VIEWS = 4
STEPS = 8


class DeviceTimer:
    """Wraps functions so each call is bracketed by CUDA events."""

    def __init__(self):
        self.spans = {}

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            self.spans.setdefault(name, []).append((a, b))
            return out
        return timed

    def mean_ms(self):
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v) / len(v) for k, v in self.spans.items()}


def staged_step(trainer, ci, it, times, cfg):
    """train_step's stages for view `ci`, timed one by one (ms, host clock)."""

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = times.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    model, settings = trainer.model, trainer._settings()
    offset = torch.zeros((model.capacity, 2), device=model.xyz.device, requires_grad=True)
    p = model.params
    out = stage("forward", lambda: loop.render(
        trainer._cam_arrays[ci], settings, p.xyz, torch.exp(p.scaling), p.rotation,
        torch.sigmoid(p.opacity[:, 0]), loop.splats_lib.features(p), trainer.bg,
        mean2d_offset=offset, live=model.live))

    def loss_fn():
        photo, _ = loop.losses.photometric_loss(out["render"], trainer._gt_images[ci],
                                                cfg.lambda_dssim)
        ln = loop.losses.normal_consistency_loss(out["rend_normal"], out["surf_normal"])
        return photo + cfg.lambda_normal * ln + cfg.lambda_dist * loop.losses.distortion_loss(
            out["rend_dist"])

    total = stage("loss", loss_fn)
    grads = stage("backward", lambda: torch.autograd.grad(total, [*p, offset]))
    gparams = loop.splats_lib.SplatParams(*grads[:-1])

    def adam():
        lrs = optim_lib.learning_rates(trainer.opt_cfg, float(it), trainer.spatial_lr_scale)
        _, trainer.adam = optim_lib.adam_step(trainer.opt_cfg, p, gparams, trainer.adam, lrs,
                                              model.live)

    stage("adam", adam)
    half = grads[-1].new_tensor([W * 0.5, H * 0.5])
    stage("stats", lambda: densify_lib.add_stats(model, grads[-1] * half[None, :],
                                                 out["radii"]))


def main() -> None:
    cams, model = synthetic.make_shell_training_set(W, H, N_SPLATS, views=VIEWS, **GT_CAPS)
    cfg = loop.TrainConfig(normal_from_iter=0, dist_from_iter=0, lambda_dist=100.0,
                           densify_from_iter=10**9, densification_interval=10**9,
                           opacity_reset_interval=10**9, loss_sync_interval=10**9)
    trainer = loop.Trainer(model, cams, W, H, spatial_lr_scale=1.0, scene_extent=1.0,
                           train_cfg=cfg, raster_kwargs=dict(CAPS))
    trainer.active_sh_degree = 3
    trainer.train(num_iters=2)  # warm up: kernel build, allocator, library handles
    torch.cuda.synchronize()

    times, timer = {}, DeviceTimer()
    native.LAUNCHES.clear()
    with mock.patch.object(cuda_backend, "blend_tiles_backward",
                           timer.wrap("blend_tiles_backward", cuda_backend.blend_tiles_backward)), \
            mock.patch.object(cuda_backend, "scatter_packed",
                              timer.wrap("scatter_packed", cuda_backend.scatter_packed)), \
            mock.patch.object(cuda_backend, "blend_tiles",
                              timer.wrap("blend_tiles", cuda_backend.blend_tiles)):
        for k in range(STEPS):
            staged_step(trainer, k % VIEWS, 3 + k, times, cfg)
    launches = {k: v / STEPS for k, v in native.LAUNCHES.items()}
    stages = {k: v / STEPS for k, v in times.items()}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(num_iters=STEPS)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train(num_iters=STEPS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    print(json.dumps({
        "scene": "shell", "steps": STEPS, "device": torch.cuda.get_device_name(0),
        "stages_ms": stages, "stages_total_ms": sum(stages.values()),
        "inside_ms": timer.mean_ms(), "launches_per_step": launches,
        "step_ms": plain_wall_ms / STEPS, "steps_per_s": STEPS / plain_wall_ms * 1e3,
        "profile": {
            "wall_ms_per_step": wall_ms / STEPS,
            "device_busy_ms_per_step": busy_ms / STEPS,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_launches_per_step": sum(e.count for e in kernels) / STEPS,
            "top": [{"kernel": e.key[:90], "calls": e.count,
                     "ms_per_step": e.self_device_time_total / 1e3 / STEPS}
                    for e in top],
        },
    }), flush=True)


if __name__ == "__main__":
    main()
