"""Production-shape training soak on one GPU (port of scripts/soak_train.py).

    python3 -m tpu2dgs_torch.eval.soak_train [iters] [W]

A synthetic orbit scene at full resolution (defaults 3000 steps, 800x800)
with densification and capacity growth on: convergence, throughput and the
capacity and overflow counters as the model grows. The ground truth is a
textured shell of 40,000 surfels at SH degree 0, its 40 orbit views
rendered through the cuda backend (K1 three times, K2 once a view); the
model starts from 8,000 noisy points at capacity 16,384 and may grow to
2^20. Training runs in chunks of 500 steps; after each chunk the run
reports the PSNR over 4 views, the live count, the capacity, the chunk's
steps per second and the overflow fractions of one render.

Prints a line a chunk and one JSON line (`soak_train`). Steps are counted
as taken: a last chunk shorter than 500 steps counts its own length (the
script counts 500 whatever the chunk took).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from tpu2dgs_torch import default_device
from tpu2dgs_torch.core import sh
from tpu2dgs_torch.eval.timing import device_label, synchronize
from tpu2dgs_torch.eval.train_bench import orbit
from tpu2dgs_torch.model import splats as splats_lib
from tpu2dgs_torch.raster.api import RasterSettings, render
from tpu2dgs_torch.train import losses
from tpu2dgs_torch.train.loop import TrainConfig, Trainer

N_GT = 40_000
N_INIT = 8_000
CAPACITY = 16_384
MAX_CAPACITY = 1 << 20
VIEWS = 40
RADIUS = 2.6
CHUNK = 500
EVAL_VIEWS = 4
RASTER = dict(backend="cuda", bin_capacity=8192, tile_capacity=2048)
OVERFLOW = ("tile_overflow_frac", "bin_overflow_frac", "col_overflow_frac",
            "grad_pack_overflow_frac")


def ground_truth(rng, n_gt: int = N_GT):
    """The textured shell of n_gt surfels, drawn from `rng` in the
    script's order: (xyz, scaling, rotation, opacity, features (N, 16, 3)
    with band 0 from the colour, rgb)."""
    theta = rng.uniform(0, np.pi, n_gt)
    phi = rng.uniform(0, 2 * np.pi, n_gt)
    rr = 0.8 + 0.1 * np.sin(4 * theta) * np.cos(3 * phi)
    xyz = np.stack([rr * np.sin(theta) * np.cos(phi),
                    rr * np.cos(theta),
                    rr * np.sin(theta) * np.sin(phi)], -1).astype(np.float32)
    scaling = np.full((n_gt, 2), 0.02, np.float32)
    rotation = rng.normal(size=(n_gt, 4)).astype(np.float32)
    opacity = rng.uniform(0.7, 0.95, (n_gt,)).astype(np.float32)
    rgb = (0.5 + 0.45 * np.stack([np.sin(3 * theta), np.cos(2 * phi),
                                  np.sin(theta + phi)], -1)).astype(np.float32)
    feats = np.zeros((n_gt, 16, 3), np.float32)
    feats[:, 0] = sh.rgb_to_sh(torch.from_numpy(np.clip(rgb, 0, 1))).numpy()
    return xyz, scaling, rotation, opacity, feats, rgb


def start_points(rng, xyz, rgb, n_init: int = N_INIT):
    """The sparse noisy start: n_init surfels of the ground truth jittered
    by 0.02, and their colours. (points, colours)."""
    sel = rng.choice(xyz.shape[0], n_init, replace=False)
    pts = xyz[sel] + rng.normal(0, 0.02, (n_init, 3)).astype(np.float32)
    return pts, np.clip(rgb[sel], 0.05, 0.95)


def train_config(iters: int) -> TrainConfig:
    return TrainConfig(
        densify_from_iter=500, densify_until_iter=int(iters * 0.8),
        densification_interval=100, opacity_reset_interval=3000,
        normal_from_iter=700, dist_from_iter=300,
        lambda_normal=0.05, lambda_dist=100.0, loss_sync_interval=50,
    )


def run(iters: int = 3000, w: int = 800, device=None, *, n_gt: int = N_GT,
        n_init: int = N_INIT, capacity: int = CAPACITY, views: int = VIEWS
        ) -> tuple[dict, Trainer]:
    """Render the ground truth, train `iters` steps in chunks; returns
    (the numbers main prints, the Trainer). The keywords cut the scene
    below the script's for tests."""
    dev = default_device(device)
    h = w
    rng = np.random.default_rng(0)
    xyz, scaling, rotation, opacity, feats, rgb = ground_truth(rng, n_gt)
    gt = tuple(torch.from_numpy(a).to(dev) for a in (xyz, scaling, rotation, opacity, feats))
    st = RasterSettings(width=w, height=h, sh_degree=0, **RASTER)
    cams = [orbit(i, views, RADIUS, w, h) for i in range(views)]
    bg = torch.zeros(3, device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        for c in cams:
            c.image = render(c.arrays(dev), st, *gt, bg, device=dev)["render"].cpu().numpy()
    gt_s = time.perf_counter() - t0
    print("GT rendered", flush=True)
    del gt

    pts, cols = start_points(rng, xyz, rgb, n_init)
    model = splats_lib.create_from_pcd(pts, cols, capacity=capacity, device=dev)
    tr = Trainer(model, cams, w, h, spatial_lr_scale=1.0, scene_extent=RADIUS,
                 train_cfg=train_config(iters), max_sh_degree=0, seed=0,
                 max_capacity=MAX_CAPACITY, raster_kwargs=dict(RASTER, grad_pack_capacity=0),
                 log_fn=None)
    gt_eval = [torch.from_numpy(c.image).to(dev) for c in cams[:EVAL_VIEWS]]

    def psnr4() -> float:
        vals = [float(losses.psnr(torch.clamp(tr.render_view(c)["render"], 0, 1), g))
                for c, g in zip(cams, gt_eval)]
        return float(np.mean(vals))

    p0 = psnr4()
    chunks = []
    done, train_s = 0, 0.0
    while done < iters:
        steps = min(CHUNK, iters - done)
        synchronize(dev)
        t0 = time.perf_counter()
        tr.train(num_iters=steps)
        synchronize(dev)
        dt = time.perf_counter() - t0
        done += steps
        train_s += dt
        out = tr.render_view(cams[0])  # the overflow counters of one render
        ovf = {k: float(out[k]) for k in OVERFLOW if k in out}
        row = {"step": done, "psnr4": psnr4(), "live": int(tr.model.num_live()),
               "capacity": tr.model.capacity, "it_per_s": steps / dt, "overflow": ovf,
               "cap_growth_events": list(tr.cap_growth_events)}
        chunks.append(row)
        print(f"[{done}] psnr4={row['psnr4']:.2f} live={row['live']} cap={row['capacity']} "
              f"{row['it_per_s']:.1f} it/s ovf={ {k: round(v, 4) for k, v in ovf.items()} }",
              flush=True)
    p1 = psnr4()
    print(f"soak done: PSNR {p0:.2f} -> {p1:.2f}, live={int(tr.model.num_live())}, "
          f"cap={tr.model.capacity}", flush=True)
    return {"w": w, "h": h, "iters": done, "gt_splats": n_gt, "start_points": n_init,
            "gt_render_seconds": gt_s, "train_seconds": train_s, "it_per_s": done / train_s,
            "psnr4_start": p0, "psnr4_end": p1, "live": int(tr.model.num_live()),
            "capacity": tr.model.capacity, "raster_kwargs": tr.raster_kwargs,
            "chunks": chunks, "device": device_label(dev)}, tr


def main(argv=None, device=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    iters = int(argv[0]) if len(argv) > 0 else 3000
    w = int(argv[1]) if len(argv) > 1 else 800
    res, _ = run(iters, w, device)
    print(json.dumps({"soak_train": res}), flush=True)
    return res


if __name__ == "__main__":
    main()
