"""Render the train and test sets of a trained model from the command line
— flag-compatible with the JAX package's `tpu2dgs.cli.render` and the
reference render.py.

    python3 -m tpu2dgs_torch.cli.render -m <model dir> --skip_mesh

Loads the trained PLY at --iteration (default: latest) and writes
renders/, gt/ and vis/ (float32 depth TIFFs) for the train and test sets
under <model>/{train,test}/ours_<iteration>/; --render_path adds a novel
trajectory. Runs on the GPU (`main(argv, device="cpu")` from Python runs
the kernels' plain versions).

Mesh extraction is not ported yet: without --skip_mesh the command raises
NotImplementedError before it renders anything. The mesh flags parse, as
the JAX package's do.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tpu2dgs_torch import default_device
from tpu2dgs_torch.cli import config as cfg_lib


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="tpu2dgs_torch rendering")
    cfg_lib.add_group(parser, cfg_lib.ModelParams, sentinel=True)
    cfg_lib.add_group(parser, cfg_lib.PipelineParams)
    cfg_lib.add_group(parser, cfg_lib.RasterParams)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--skip_mesh", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--render_path", action="store_true")
    parser.add_argument("--voxel_size", default=-1.0, type=float)
    parser.add_argument("--depth_trunc", default=-1.0, type=float)
    parser.add_argument("--sdf_trunc", default=-1.0, type=float)
    parser.add_argument("--num_cluster", default=50, type=int)
    parser.add_argument("--cull_views", default=0, type=int,
                        help="cull mesh faces unseen by fewer than N training views")
    parser.add_argument("--cull_eps", default=0.01, type=float)
    parser.add_argument("--unbounded", action="store_true")
    parser.add_argument("--mesh_res", default=1024, type=int)
    return parser


def _chw(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _save_u8(path: str, chw) -> None:
    from PIL import Image

    arr = np.clip(_chw(chw).transpose(1, 2, 0), 0, 1)
    Image.fromarray((arr * 255).astype(np.uint8)).save(path)


def _save_depth_tiff(path: str, depth_hw) -> None:
    from tpu2dgs_torch.data.paths import save_img_f32

    save_img_f32(_chw(depth_hw), path)


def latest_iteration(model_path: str) -> int:
    base = os.path.join(model_path, "point_cloud")
    iters = [int(d.split("_")[-1]) for d in os.listdir(base)
             if d.startswith("iteration_")]
    return max(iters)


@torch.no_grad()
def main(argv=None, device=None):
    from tpu2dgs_torch.data.scene import Scene
    from tpu2dgs_torch.model import splats as splats_lib
    from tpu2dgs_torch.raster.api import RasterSettings, render

    parser = build_parser()
    args = cfg_lib.get_combined_args(parser, argv)
    if not args.skip_mesh:
        raise NotImplementedError(
            "mesh extraction is not ported yet (it comes with the mesh slice): "
            "pass --skip_mesh to render the train and test sets only")
    model_p = cfg_lib.extract(cfg_lib.ModelParams, args)
    pipe_p = cfg_lib.extract(cfg_lib.PipelineParams, args)
    raster_p = cfg_lib.extract(cfg_lib.RasterParams, args)
    raster_p.backend = cfg_lib.port_backend(raster_p.backend)
    dev = default_device(device)

    it = args.iteration if args.iteration != -1 else latest_iteration(model_p.model_path)
    ply = os.path.join(model_p.model_path, "point_cloud", f"iteration_{it}",
                       "point_cloud.ply")
    model = splats_lib.load_ply(ply, sh_degree=model_p.sh_degree, device=dev)
    print(f"Loaded {int(model.num_live())} splats from {ply}")

    scene = Scene.load(
        model_p.source_path, images_dir=model_p.images,
        resolution=model_p.resolution,
        white_background=model_p.white_background,
        eval_split=model_p.eval, shuffle=False,
    )
    cam0 = (scene.train_cameras + scene.test_cameras)[0]
    w, h = cam0.width, cam0.height
    bg = (torch.ones if model_p.white_background else torch.zeros)(
        3, dtype=torch.float32, device=dev)
    settings = RasterSettings(
        width=w, height=h, sh_degree=model_p.sh_degree,
        depth_ratio=pipe_p.depth_ratio, backend=raster_p.backend,
        bin_capacity=raster_p.bin_capacity, tile_capacity=raster_p.tile_capacity,
    )
    p = model.params
    splat_args = (p.xyz, torch.exp(p.scaling), p.rotation,
                  torch.sigmoid(p.opacity[:, 0]), splats_lib.features(p))

    def render_fn(cam):
        return render(
            cam.arrays(dev), settings, *splat_args, bg, live=model.live, device=dev,
            convert_shs_python=pipe_p.convert_SHs_python,
            compute_cov3d_python=pipe_p.compute_cov3D_python)

    def export_set(cameras, name):
        base = os.path.join(model_p.model_path, name, f"ours_{it}")
        rdir = os.path.join(base, "renders")
        gdir = os.path.join(base, "gt")
        vdir = os.path.join(base, "vis")
        for d in (rdir, gdir, vdir):
            os.makedirs(d, exist_ok=True)
        for i, cam in enumerate(cameras):
            out = render_fn(cam)
            _save_u8(os.path.join(rdir, f"{i:05d}.png"), out["render"])
            if cam.image is not None:
                _save_u8(os.path.join(gdir, f"{i:05d}.png"), cam.image)
            _save_depth_tiff(os.path.join(vdir, f"depth_{i:05d}.tiff"),
                             out["surf_depth"][0])
        print(f"exported {len(cameras)} views to {base}")

    if not args.skip_train:
        export_set(scene.train_cameras, "train")
    if not args.skip_test and scene.test_cameras:
        export_set(scene.test_cameras, "test")

    if args.render_path:
        from tpu2dgs_torch.data.paths import create_videos, generate_path, save_img_u8

        traj_dir = os.path.join(model_p.model_path, "traj", f"ours_{it}")
        os.makedirs(traj_dir, exist_ok=True)
        for i, cam in enumerate(generate_path(scene.train_cameras, n_frames=240)):
            out = render_fn(cam)
            save_img_u8(_chw(out["render"]).transpose(1, 2, 0),
                        os.path.join(traj_dir, f"{i:05d}.png"))
        create_videos(traj_dir, os.path.join(model_p.model_path, f"traj_{it}.mp4"))
        print(f"render path saved at {traj_dir}")


if __name__ == "__main__":
    main()
