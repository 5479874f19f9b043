"""Synthetic end-to-end quality gate: cli.train -> cli.render (with the
mesh) -> cli.metrics -> Chamfer, with fixed thresholds (port of
scripts/quality_gate.py).

    python3 -m tpu2dgs_torch.eval.quality_gate [out_dir] [iters] [res] [--soak] [--backend B]

The scene's ground truth is known exactly: a textured surfel shell (a
radius ~0.8 sphere with bumps, 4000 surfels from seed 0) rendered by the
tiled backend from 24 orbit views into a Blender-format dataset; even views
train, odd views are held out. The real command line then trains on it
(`iters` iterations, densification from 100 to 0.8 iters every 50, random
initial points as the reference's Blender protocol), renders both splits,
fuses the bounded TSDF mesh (voxel 0.02) and scores

  * novel-view PSNR and SSIM on the held-out views (cli.metrics),
  * the Chamfer distance of fuse_post.ply to exact samples of the shell
    (20,000 from seed 3),
  * the trained model's held-out view 1 rendered through the cuda backend
    (the kernels) and through the tiled backend, at capacities taken from
    both backends' demand, as a PSNR of one against the other.

The thresholds are the JAX gate's: PSNR >= 19 dB, Chamfer <= 0.06, cross
>= 40 dB; `--soak` (a compressed 30K schedule: 1500 initial points, opacity
resets, capacity growth) allows Chamfer <= 0.12 and asks for >= 6000 final
points. Calibrated at 2000 iterations and 128 px. `--backend` picks the
training backend (default cuda, the kernels), and cli.render renders and
meshes on it at capacities sized to the trained model's demand. Prints one
JSON line. Runs on
the GPU; `main(..., device="cpu")` from Python runs the kernels' plain
versions.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from tpu2dgs_torch import default_device

PSNR_MIN = 19.0
CHAMFER_MAX = 0.06
CROSS_PSNR_MIN = 40.0
SOAK_CHAMFER_MAX = 0.12
SOAK_POINTS_MIN = 6000

N_VIEWS = 24
FOV = 0.9
GT_CAPS = dict(bin_capacity=1024, tile_capacity=512)
# Capacities of the demand probes before the cross-render.
PROBE_CAPS = dict(bin_capacity=16384, tile_capacity=8192, col_capacity=61440)


def make_shell(n_gt=4000, seed=0):
    """The generating surfels: (xyz, rgb, scaling, rotation, opacity)."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, np.pi, n_gt)
    phi = rng.uniform(0, 2 * np.pi, n_gt)
    rr = 0.8 + 0.1 * np.sin(4 * theta) * np.cos(3 * phi)
    xyz = np.stack([rr * np.sin(theta) * np.cos(phi),
                    rr * np.cos(theta),
                    rr * np.sin(theta) * np.sin(phi)], -1).astype(np.float32)
    rgb = (0.5 + 0.45 * np.stack([np.sin(3 * theta), np.cos(2 * phi),
                                  np.sin(theta + phi)], -1)).astype(np.float32)
    scaling = np.full((n_gt, 2), 0.035, np.float32)
    rotation = rng.normal(size=(n_gt, 4)).astype(np.float32)
    opacity = rng.uniform(0.75, 0.95, (n_gt,)).astype(np.float32)
    return xyz, rgb, scaling, rotation, opacity


def shell_surface_points(n=20000, seed=3):
    """Dense exact samples of the generating surface r(theta, phi)."""
    rng = np.random.default_rng(seed)
    theta = np.arccos(rng.uniform(-1, 1, n))
    phi = rng.uniform(0, 2 * np.pi, n)
    rr = 0.8 + 0.1 * np.sin(4 * theta) * np.cos(3 * phi)
    return np.stack([rr * np.sin(theta) * np.cos(phi),
                     rr * np.cos(theta),
                     rr * np.sin(theta) * np.sin(phi)], -1)


def orbit_views(res: int):
    """The 24 orbit cameras and their Blender (OpenGL) camera-to-world
    matrices."""
    from tpu2dgs_torch.core.cameras import Camera

    views = []
    for i in range(N_VIEWS):
        a = 2 * np.pi * i / N_VIEWS
        el = 0.35 * np.sin(2 * a)
        fwd_gl = np.array([np.cos(el) * np.sin(a), np.sin(el), np.cos(el) * np.cos(a)])
        pos = 2.6 * fwd_gl
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd_gl)
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = (
            right, np.cross(fwd_gl, right), fwd_gl, pos)
        gl = c2w.copy()
        gl[:3, 1:3] *= -1
        w2c = np.linalg.inv(gl)
        cam = Camera(uid=i, image_name=f"r_{i}", R=w2c[:3, :3].T, T=w2c[:3, 3],
                     fovx=FOV, fovy=FOV, width=res, height=res)
        views.append((cam, c2w))
    return views


def shell_features(rgb: np.ndarray) -> np.ndarray:
    """SH coefficients (N, 16, 3) whose DC band gives `rgb`."""
    from tpu2dgs_torch.core.sh import C0

    features = np.zeros((len(rgb), 16, 3), np.float32)
    features[:, 0] = (rgb - 0.5) / float(C0)
    return features


@torch.no_grad()
def render_ground_truth(cam, res: int, device):
    """One view of the generating shell through the tiled backend at SH
    degree 0, on a black background: (3, res, res)."""
    from tpu2dgs_torch.raster.api import RasterSettings, render

    xyz, rgb, scaling, rotation, opacity = make_shell()
    gt = [torch.from_numpy(a).to(device)
          for a in (xyz, scaling, rotation, opacity, shell_features(rgb))]
    settings = RasterSettings(width=res, height=res, sh_degree=0, backend="tiled", **GT_CAPS)
    return render(cam.arrays(device), settings, *gt, torch.zeros(3, device=device),
                  device=device)["render"]


def write_dataset(src: str, res: int, device):
    """The Blender-format dataset under `src`; returns held-out view 1."""
    from PIL import Image

    os.makedirs(src, exist_ok=True)
    frames = []
    for i, (cam, c2w) in enumerate(orbit_views(res)):
        img = render_ground_truth(cam, res, device).cpu().numpy()
        Image.fromarray(
            (np.clip(img.transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
        ).save(os.path.join(src, f"r_{i}.png"))
        frames.append({"file_path": f"r_{i}", "transform_matrix": c2w.tolist()})
        if i == 1:
            test_cam = cam
    for split, part in (("train", frames[::2]), ("test", frames[1::2])):
        with open(os.path.join(src, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": FOV, "frames": part}, f)
    return test_cam


def r128(x) -> int:
    return max(128, -(-int(x) // 128) * 128)


@torch.no_grad()
def demand_flags(model, cams, device, backend: str = "cuda") -> list[str]:
    """cli.render's flags for `backend` at capacities of its largest demand
    over `cams`, read from its overflow counters (*_count_max) at
    PROBE_CAPS. cli.render renders at its flags' capacities, and their
    defaults truncate the lists of a trained model (ROADMAP.md §3)."""
    from tpu2dgs_torch.model import splats as splats_lib
    from tpu2dgs_torch.raster.api import RasterSettings, render

    p = model.params
    args = (p.xyz, torch.exp(p.scaling), p.rotation, torch.sigmoid(p.opacity[:, 0]),
            splats_lib.features(p))
    bg = torch.zeros(3, device=device)
    demand = {"bin_capacity": 128, "tile_capacity": 128, "col_capacity": 128}
    for cam in cams:
        settings = RasterSettings(width=cam.width, height=cam.height, backend=backend,
                                  **PROBE_CAPS)
        out = render(cam.arrays(device), settings, *args, bg, live=model.live, device=device)
        for kwarg in demand:
            count = out.get(kwarg.replace("capacity", "count_max"))  # tiled has no columns
            if count is not None:
                demand[kwarg] = max(demand[kwarg], r128(float(count)))
    return ["--backend", backend,
            *(a for kwarg, v in demand.items() for a in (f"--{kwarg}", str(v)))]


@torch.no_grad()
def cross_psnr(model, cam, res: int, device) -> float:
    """PSNR between the model's view through the cuda backend and through
    the tiled one. Under truncation their tile lists differ legitimately
    (exact coverage against boxes), so both render at capacities above the
    larger of the two backends' demand."""
    from tpu2dgs_torch.model import splats as splats_lib
    from tpu2dgs_torch.raster.api import RasterSettings, render

    p = model.params
    args = (p.xyz, torch.exp(p.scaling), p.rotation, torch.sigmoid(p.opacity[:, 0]),
            splats_lib.features(p))
    cam_arrays = cam.arrays(device)
    bg = torch.zeros(3, device=device)

    def view(**kw):
        settings = RasterSettings(width=res, height=res, sh_degree=3, **kw)
        return render(cam_arrays, settings, *args, bg, live=model.live, device=device)

    tile_d = bin_d = col_d = 128.0
    for be in ("cuda", "tiled"):
        dp = view(backend=be, **PROBE_CAPS)
        tile_d = max(tile_d, float(dp["tile_count_max"]))
        bin_d = max(bin_d, float(dp["bin_count_max"]))
        col_d = max(col_d, float(dp.get("col_count_max", 128.0)))
    caps = dict(bin_capacity=r128(bin_d), tile_capacity=r128(tile_d),
                col_capacity=min(r128(col_d), PROBE_CAPS["col_capacity"]))
    a, b = (torch.clamp(view(backend=be, **caps)["render"], 0, 1) for be in ("cuda", "tiled"))
    err = float(torch.mean((a - b) ** 2))
    return float(-10.0 * np.log10(max(err, 1e-12)))


def verdict(psnr: float, chamfer: float, cross: float, final_points: int,
            soak: bool) -> tuple[dict, bool]:
    """(thresholds, pass) of the gate."""
    thresholds = {"psnr_db": PSNR_MIN, "chamfer": CHAMFER_MAX,
                  "backend_cross_psnr_db": CROSS_PSNR_MIN}
    if soak:
        # The compressed schedule's geometry gets fewer settled iterations;
        # the soak gates the schedule's machinery, the standard gate quality.
        thresholds.update(chamfer=SOAK_CHAMFER_MAX, final_points=SOAK_POINTS_MIN)
    ok = (psnr >= PSNR_MIN and chamfer <= thresholds["chamfer"] and cross >= CROSS_PSNR_MIN
          and final_points >= thresholds.get("final_points", 0))
    return thresholds, bool(ok)


def main(out_dir=None, iters: int = 2000, res: int = 128, soak: bool = False,
         backend: str = "cuda", device=None) -> dict:
    """Run the gate; print and return its report."""
    from tpu2dgs_torch.cli import metrics as cli_metrics
    from tpu2dgs_torch.cli import render as cli_render
    from tpu2dgs_torch.cli import train as cli_train
    from tpu2dgs_torch.eval import geometry
    from tpu2dgs_torch.model.splats import load_ply, read_ply_vertices

    dev = default_device(device)
    tmp = None
    if out_dir is None:
        tmp = out_dir = tempfile.mkdtemp(prefix="qgate_")
    src = os.path.join(out_dir, "scene")
    out = os.path.join(out_dir, "model")
    test_cam = write_dataset(src, res, dev)

    schedule = (
        # compressed 30K schedule: a small random init, so densification
        # must grow the capacity repeatedly, and >= 2 opacity resets
        ["--opacity_reset_interval", str(max(iters // 3, 200)), "--num_init_points", "1500"]
        if soak else ["--opacity_reset_interval", "100000"])
    cli_train.main([
        "-s", src, "-m", out, "--eval", "--iterations", str(iters),
        "--save_iterations", str(iters), "--test_iterations", str(iters),
        "--densify_from_iter", "100", "--densify_until_iter", str(int(iters * 0.8)),
        "--densification_interval", "50",
        "--bin_capacity", "1024", "--tile_capacity", "512",
        "--backend", backend, "--quiet", "--max_capacity", "131072", "--disable_viewer",
    ] + schedule, device=dev)
    trained = load_ply(os.path.join(out, "point_cloud", f"iteration_{iters}",
                                    "point_cloud.ply"), device=dev)
    # the renders and the mesh on the training backend, at capacities with
    # room for every list of every view
    flags = demand_flags(trained, [cam for cam, _ in orbit_views(res)], dev, backend)
    cli_render.main([
        "-m", out, "--quiet", "--skip_train", *flags,
        "--voxel_size", "0.02", "--sdf_trunc", "0.06", "--depth_trunc", "5.0",
        "--num_cluster", "1",
    ], device=dev)
    cli_metrics.main(["-m", out, "--no_lpips"], device=dev)

    with open(os.path.join(out, "results.json")) as f:
        results = json.load(f)[f"ours_{iters}"]
    psnr, ssim = float(results["PSNR"]), float(results["SSIM"])

    vv = read_ply_vertices(os.path.join(out, "train", f"ours_{iters}", "fuse_post.ply"))
    verts = np.stack([vv["x"], vv["y"], vv["z"]], -1).astype(np.float64)
    _, _, chamfer = geometry.chamfer_distance(verts, shell_surface_points())

    cross = cross_psnr(trained, test_cam, res, dev)
    final_points = int(trained.num_live())

    thresholds, ok = verdict(psnr, chamfer, cross, final_points, soak)
    report = {
        "metric": "synthetic_quality_gate",
        "backend": backend,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "iters": iters, "res": res,
        "psnr_db": round(psnr, 2),
        "ssim": round(ssim, 4),
        "chamfer": round(float(chamfer), 4),
        "mesh_vertices": int(len(verts)),
        "render_capacities": {k.lstrip("-"): int(v) for k, v in zip(flags[2::2], flags[3::2])},
        "backend_cross_psnr_db": round(cross, 2),
        "final_points": final_points,
        "thresholds": thresholds,
        "pass": ok,
    }
    if soak:
        report["soak"] = True
    print(json.dumps(report), flush=True)
    if tmp is not None:
        shutil.rmtree(tmp, ignore_errors=True)
    return report


def _parse(argv=None):
    parser = argparse.ArgumentParser(description="synthetic end-to-end quality gate")
    parser.add_argument("out_dir", nargs="?", default=None)
    parser.add_argument("iters", nargs="?", type=int, default=2000)
    parser.add_argument("res", nargs="?", type=int, default=128)
    parser.add_argument("--soak", action="store_true")
    parser.add_argument("--backend", default="cuda", choices=("cuda", "tiled", "oracle"))
    return parser.parse_args(argv)


if __name__ == "__main__":
    a = _parse()
    main(a.out_dir, a.iters, a.res, soak=a.soak, backend=a.backend)
