"""Render the train and test sets of a trained model and extract its mesh
from the command line — flag-compatible with the JAX package's
`tpu2dgs.cli.render` and the reference render.py.

    python3 -m tpu2dgs_torch.cli.render -m <model dir> [--unbounded --mesh_res 1024]

Loads the trained PLY at --iteration (default: latest) and writes
renders/, gt/ and vis/ (float32 depth TIFFs) for the train and test sets
under <model>/{train,test}/ours_<iteration>/; --render_path adds a novel
trajectory. Unless --skip_mesh is given, it renders every training view
again with diffuse colour (SH degree 0), fuses the depth maps into a TSDF on
the device (bounded: fuse.ply, or contracted with --unbounded:
fuse_unbounded.ply), optionally culls faces seen by fewer than --cull_views
views, and keeps the --num_cluster largest clusters (*_post.ply), all under
<model>/train/ours_<iteration>/. The capacity flags are initial values:
a view whose lists overflow is rendered again at grown capacities, as the
Trainer heals its own (raster/capacity.py), and the capacities carry over
to the views after it; a view still truncated at the growth ceilings is
written and reported. Runs on the GPU (`main(argv, device="cpu")` from
Python runs the kernels' plain versions, and returns the capacities the
run ended at).
"""

from __future__ import annotations

import argparse
import dataclasses
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
    # a backend stored in cfg_args wins over the default (RasterParams'
    # "cuda") unless --backend is given
    parser.set_defaults(backend=None)
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
    from tpu2dgs_torch.raster.capacity import RENDER_CAPS, CapacityHealer

    parser = build_parser()
    args = cfg_lib.get_combined_args(parser, argv)
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
        tile_px=raster_p.tile_px, coarse_tiles=raster_p.coarse_tiles, chunk=raster_p.chunk,
    )
    healer = CapacityHealer({k: getattr(raster_p, k) for k in RENDER_CAPS})
    p = model.params
    splat_args = (p.xyz, torch.exp(p.scaling), p.rotation,
                  torch.sigmoid(p.opacity[:, 0]), splats_lib.features(p))

    def render_fn(cam, sh_degree=model_p.sh_degree):
        return healer.render(lambda caps: render(
            cam.arrays(dev), dataclasses.replace(settings, sh_degree=sh_degree, **caps),
            *splat_args, bg, live=model.live, device=dev,
            convert_shs_python=pipe_p.convert_SHs_python,
            compute_cov3d_python=pipe_p.compute_cov3D_python), cam.image_name)

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

    if not args.skip_mesh:
        extract_mesh(args, scene.train_cameras, lambda cam: render_fn(cam, sh_degree=0),
                     os.path.join(model_p.model_path, "train", f"ours_{it}"), dev)
    if healer.events:
        print(f"rendered at {healer.caps} after {healer.rerenders} re-renders of "
              f"{healer.views} views")
    for key, (views, most) in healer.truncated.items():
        print(f"{views} of {healer.views} views written truncated: {key} up to {most:.6g}")
    return dict(healer.caps)


def extract_mesh(args, cameras, render_fn, out_dir: str, device) -> None:
    """Fuse the training views' renders into a mesh and write it, then its
    culled and cluster-filtered form. `render_fn` renders with diffuse colour
    only: the reference forces active_sh_degree = 0 before reconstruction so
    fused vertex colours carry no view dependence (reference render.py:89-90)."""
    from tpu2dgs_torch.mesh.extract import (
        GaussianExtractor, post_process_mesh, write_mesh_ply,
    )

    ex = GaussianExtractor(render_fn, device=device)
    ex.reconstruction(cameras)
    name = "fuse.ply"
    if args.unbounded:
        name = "fuse_unbounded.ply"
        verts, faces, colors = ex.extract_mesh_unbounded(resolution=args.mesh_res)
    else:
        depth_trunc = (ex.radius * 2.0) if args.depth_trunc < 0 else args.depth_trunc
        voxel_size = (depth_trunc / args.mesh_res) if args.voxel_size < 0 else args.voxel_size
        sdf_trunc = 5.0 * voxel_size if args.sdf_trunc < 0 else args.sdf_trunc
        verts, faces, colors = ex.extract_mesh_bounded(
            voxel_size=voxel_size, sdf_trunc=sdf_trunc, depth_trunc=depth_trunc)
    out_path = os.path.join(out_dir, name)
    os.makedirs(out_dir, exist_ok=True)
    write_mesh_ply(out_path, verts, faces, colors)
    print(f"mesh saved at {out_path}")
    if args.cull_views > 0:
        # optional visibility culling against the training views' rendered
        # depths (the reference's TnT cull_mesh, which its mainline leaves
        # disabled; mesh/cull.py)
        from tpu2dgs_torch.mesh.cull import cull_mesh

        verts, faces, kept = cull_mesh(
            verts, faces, ex.cameras, ex.depthmaps,
            eps=args.cull_eps, min_views=args.cull_views)
        colors = colors[kept]
        print(f"culled to {len(verts)} vertices ({args.cull_views}+ views)")
    verts, faces, colors = post_process_mesh(
        verts, faces, colors, num_cluster=args.num_cluster)
    post_path = out_path.replace(".ply", "_post.ply")
    write_mesh_ply(post_path, verts, faces, colors)
    print(f"mesh post processed saved at {post_path}")


if __name__ == "__main__":
    main()
