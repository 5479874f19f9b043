"""Where a served view's time goes on the GPU.

    python3 -m tpu2dgs_torch.eval.serve_profile

Serves the scenes of chip_smoke.py at the bench size (800x800, 131,072
splats at SH degree 3, the bench capacities) and prints one JSON line per
scene with

  * `stages`: host-clock ms of each render stage, each ending in a
    torch.cuda.synchronize(), mean over the views: preprocess, depth
    compaction + record packing, the three select levels, the blend with
    its untile and counters, and the output decoding;
  * `profile`: torch.profiler over the same views: the device's busy time
    (the sum of its kernels' times), the window's wall time, the idle
    share, and the kernels that take the most device time.

Needs a CUDA device; the kernels build on first use.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tpu2dgs_torch.eval import synthetic
from tpu2dgs_torch.raster import api, binning, cuda_backend, preprocess

W = H = 800
N_SPLATS = 1 << 17
CAPS = dict(bin_capacity=8192, tile_capacity=2048, col_capacity=32768)
VIEWS = 4


def staged_render(cam, settings, scene, bg, live):
    """api.render's steps, timed one by one (ms, host clock)."""
    times = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = times.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    w, h = settings.width, settings.height
    nbx, nty = -(-w // cuda_backend.BX), -(-h // cuda_backend.BY)
    n = scene[0].shape[0]
    cap = min(settings.tile_capacity, n)
    bin_cap = max(min(settings.bin_capacity, n), cap)
    splats = stage("preprocess", lambda: preprocess.preprocess(
        *scene, cam, w, h, settings.sh_degree, live=live))
    comp, rec = stage("compact_pack", lambda: (binning.compact_visible(splats, n),
                                                cuda_backend.pack_records(splats)))
    rec3, raw, _, _ = stage("select_levels", lambda: cuda_backend._bin_records(
        comp.x0, comp.x1, comp.y0, comp.y1, comp.num_visible, rec, nbx, nty, bin_cap,
        cap, col_cap=settings.col_capacity, ids=comp.perm))
    image, allmap = stage("blend_untile", lambda: cuda_backend.blend_binned(
        rec3, raw, settings, bg, nbx, nty, {}))
    stage("decode", lambda: api.decode_outputs(cam, settings, splats, image, allmap))
    return times


def run(name, cams, scene, live, settings):
    bg = torch.zeros(3, device=scene[0].device)
    for cam in cams[:1]:  # warm up: kernel build, allocator, cuBLAS/cuSOLVER handles
        api.render(cam, settings, *scene, bg, live=live)
    torch.cuda.synchronize()

    totals = {}
    for cam in cams:
        for k, v in staged_render(cam, settings, scene, bg, live).items():
            totals[k] = totals.get(k, 0.0) + v / len(cams)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for cam in cams:
            api.render(cam, settings, *scene, bg, live=live)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    print(json.dumps({
        "scene": name, "views": len(cams), "device": torch.cuda.get_device_name(0),
        "stages_ms": totals, "stages_total_ms": sum(totals.values()),
        "profile": {
            "wall_ms_per_view": wall_ms / len(cams),
            "device_busy_ms_per_view": busy_ms / len(cams),
            "idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_launches_per_view": sum(e.count for e in kernels) / len(cams),
            "top": [{"kernel": e.key[:90], "calls": e.count,
                     "ms_per_view": e.self_device_time_total / 1e3 / len(cams)}
                    for e in top],
        },
    }), flush=True)


def main() -> None:
    settings = api.RasterSettings(W, H, **CAPS)
    _, shell = synthetic.make_shell_scene(W, H, N_SPLATS)
    cams = [synthetic.shell_camera(2 * np.pi * (0.13 + k / VIEWS), W, H).arrays()
            for k in range(VIEWS)]
    model = synthetic.scene_model(shell)
    run("shell", cams, shell, model.live, settings)
    cam, bench = synthetic.make_bench_scene(W, H, N_SPLATS)
    run("bench", [cam] * VIEWS, bench, None, settings)


if __name__ == "__main__":
    main()
