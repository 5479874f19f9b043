"""End-to-end training throughput on one GPU (port of scripts/train_bench.py).

    python3 -m tpu2dgs_torch.eval.train_bench [iters] [W] [N_log2]

Production-shape steady state: a textured surfel SHELL (opaque surfaces
that saturate transmittance early, like trained scenes) at full resolution
and production splat count (defaults 300 steps, 800x800, 2^17 splats),
the full Trainer step (render forward and backward through K1-K3, the
loss, Adam, the densification statistics) on the cuda backend.
Densification and opacity resets are off, so the measurement is the
steady per-step cost; the warm-up trains until the Trainer's adaptive
capacities settle (a pass of two densification intervals and 10 steps
that makes no growth event), and a growth event inside the timed window
fails the run.

Prints the rate and one JSON line (`train_bench`: it/s, Mpix/s, the settled
capacities, the growth events; `card`: the GPU's name and power limit).
`main(argv, device="cpu")` runs the same on the CPU through the kernels'
plain versions (its rate is the CPU's).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from tpu2dgs_torch import default_device
from tpu2dgs_torch.core import cameras
from tpu2dgs_torch.eval.timing import device_label, synchronize
from tpu2dgs_torch.model import splats as splats_lib
from tpu2dgs_torch.train.loop import TrainConfig, Trainer

VIEWS = 24
RADIUS = 2.6
RASTER = dict(backend="cuda", bin_capacity=8192, tile_capacity=2048, grad_pack_capacity=0)


def shell_scene(n, rng):
    """Textured surfel shell: opaque surfaces, production-like depth
    complexity (the family of soak_train's ground truth). (xyz, rgb)."""
    theta = rng.uniform(0, np.pi, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    rr = 0.8 + 0.1 * np.sin(4 * theta) * np.cos(3 * phi)
    xyz = np.stack([rr * np.sin(theta) * np.cos(phi),
                    rr * np.cos(theta),
                    rr * np.sin(theta) * np.sin(phi)], -1).astype(np.float32)
    rgb = (0.5 + 0.45 * np.stack([np.sin(3 * theta), np.cos(2 * phi),
                                  np.sin(theta + phi)], -1)).astype(np.float32)
    return xyz, np.clip(rgb, 0.05, 0.95)


def orbit(i, n, radius, w, h) -> cameras.Camera:
    """View i of n on an orbit of `radius` around the origin, looking in."""
    a = 2 * np.pi * i / n
    fwd = np.array([-np.sin(a), 0.12 * np.sin(3 * a), -np.cos(a)])
    fwd /= np.linalg.norm(fwd)
    pos = -radius * fwd
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    tu = np.cross(fwd, right)
    Rw2v = np.stack([right, tu, fwd])
    return cameras.Camera(
        uid=i, image_name=f"v{i}", R=Rw2v.T, T=-Rw2v @ pos,
        fovx=np.pi / 3, fovy=np.pi / 3, width=w, height=h)


def problem(w: int, h: int, n: int):
    """(cameras, points, colours) from one default_rng(0): the 24 orbit
    views' random images are drawn first, then the shell's points."""
    rng = np.random.default_rng(0)
    cams = []
    for i in range(VIEWS):
        cam = orbit(i, VIEWS, RADIUS, w, h)
        cam.image = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
        cams.append(cam)
    pts, cols = shell_scene(n, rng)
    return cams, pts, cols


def train_config(interval: int = TrainConfig.densification_interval) -> TrainConfig:
    return TrainConfig(
        densification_interval=interval,
        densify_from_iter=10 ** 9,  # steady-state step timing (no growth)
        opacity_reset_interval=10 ** 9,
        normal_from_iter=0, dist_from_iter=0,
        lambda_normal=0.05, lambda_dist=100.0,
        loss_sync_interval=50,
    )


def run(iters: int = 300, w: int = 800, n: int = 1 << 17, device=None, *,
        interval: int = TrainConfig.densification_interval) -> dict:
    """Settle the adaptive capacities, then time `iters` steps; returns the
    numbers main prints. `interval` (the densification interval, the
    cadence of capacity growth) shortens the settle passes for tests."""
    dev = default_device(device)
    h = w
    cams, pts, cols = problem(w, h, n)
    model = splats_lib.create_from_pcd(pts, cols, capacity=n, device=dev)
    cfg = train_config(interval)
    tr = Trainer(model, cams, w, h, spatial_lr_scale=1.0, scene_extent=RADIUS,
                 train_cfg=cfg, max_sh_degree=3, raster_kwargs=dict(RASTER), seed=0)

    # Warm until the adaptive caps settle: run past at least two
    # densification-interval boundaries (cap growth triggers there), again
    # after any growth.
    settle = 0
    t0 = time.perf_counter()
    while True:
        before = len(tr.cap_growth_events)
        tr.train(num_iters=2 * cfg.densification_interval + 10)
        settle += 2 * cfg.densification_interval + 10
        if len(tr.cap_growth_events) == before:
            break
    synchronize(dev)
    settle_s = time.perf_counter() - t0

    events_before = len(tr.cap_growth_events)
    t0 = time.perf_counter()
    tr.train(num_iters=iters)
    synchronize(dev)
    dt = time.perf_counter() - t0
    if len(tr.cap_growth_events) != events_before:
        raise RuntimeError(f"cap growth inside the timed window: {tr.cap_growth_events}")
    it_s = iters / dt
    return {"w": w, "h": h, "splats": n, "iters": iters, "timed_seconds": dt, "it_per_s": it_s,
            "mpix_per_s": it_s * w * h / 1e6, "settle_iters": settle,
            "settle_seconds": settle_s, "cap_growth_events": tr.cap_growth_events,
            "raster_kwargs": tr.raster_kwargs, "device": device_label(dev)}


def main(argv=None, device=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    iters = int(argv[0]) if len(argv) > 0 else 300
    w = int(argv[1]) if len(argv) > 1 else 800
    n = 1 << (int(argv[2]) if len(argv) > 2 else 17)
    res = run(iters, w, n, device)
    if res["cap_growth_events"]:
        print(f"cap growth during warmup ({res['settle_iters']} iters): "
              f"{res['cap_growth_events']}")
    print(f"train_bench: {w}x{w}, {n} splats (shell), {iters} iters: "
          f"{res['it_per_s']:.2f} it/s  ({res['mpix_per_s']:.2f} Mpix/s)")
    print(json.dumps({"train_bench": res}), flush=True)
    return res


if __name__ == "__main__":
    main()
