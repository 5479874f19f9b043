"""Training from the command line — flag-compatible with the JAX package's
`tpu2dgs.cli.train` and the reference train.py.

    python3 -m tpu2dgs_torch.cli.train -s <data> -m <output> [--iterations 30000] ...

Runs on the GPU. `main(argv, device="cpu")` from Python runs the kernels'
plain versions on the CPU, as the tests do; there is no flag for it.

`--n_devices N` (N > 1; 0 = every GPU) splits each view's tile rows over N
ranks, one process per GPU (`--shard_mode rows`, parallel/sharded.py): the
run spawns ranks on cuda:0 .. cuda:N-1, and raises when the host has fewer
GPUs. `--shard_mode splats` splits the splats as well: each rank keeps
1/N of the model, its Adam state and its statistics (the cuda backend;
with one device it trains unsharded). Started by a launcher that set
WORLD_SIZE, RANK, MASTER_ADDR and MASTER_PORT (torchrun), or called in a
rank of a group already made (`parallel.distributed.spawn`), it trains in
that group instead, one rank per process. From Python with device="cpu" it
runs N gloo ranks on the CPU. Rank 0 alone logs and writes the model
directory. Under splat sharding the whole model lies on a device at no
point: it is made (or a resume loads it) in host memory, and each rank
keeps its segment; every rank renders the test views together; at each
save and checkpoint iteration the segments are gathered into rank 0's
host memory, written and released.

Without `--disable_viewer` a one-device run serves the remote viewer on
--ip/--port between steps (viewer/network_gui.py, `Trainer.gui`); if the
port cannot be opened it says so and trains without. Under a mesh the
viewer is not served (a later slice) and the run says so.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import uuid

import numpy as np
import torch

from tpu2dgs_torch import default_device
from tpu2dgs_torch.cli import config as cfg_lib
from tpu2dgs_torch.parallel import distributed, sharded


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="tpu2dgs_torch training")
    cfg_lib.add_group(parser, cfg_lib.ModelParams)
    cfg_lib.add_group(parser, cfg_lib.OptimizationParams)
    cfg_lib.add_group(parser, cfg_lib.PipelineParams)
    cfg_lib.add_group(parser, cfg_lib.RasterParams)
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--detect_anomaly", action="store_true", default=False)
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--disable_viewer", action="store_true", default=False)
    parser.add_argument("--max_capacity", type=int, default=4_194_304)
    parser.add_argument(
        "--num_init_points", type=int, default=None,
        help="Blender random-init cloud size (default: the reference's 100K)")
    parser.add_argument("--camera_batch", type=int, default=1)
    parser.add_argument(
        "--gt_cache_mb", type=float, default=None,
        help="device-memory budget for pre-staged GT images; scenes over "
        "it keep GT in pinned host memory with the next views copied ahead "
        "on a side stream (default: pre-stage everything)")
    parser.add_argument(
        "--n_devices", type=int, default=1,
        help="devices (ranks) to split each view's tile rows over; 0 = every GPU")
    parser.add_argument(
        "--profile_dir", type=str, default="",
        help="capture a torch.profiler trace of training steps 100-110 into "
        "this directory (a Chrome trace)")
    parser.add_argument(
        "--shard_mode", choices=("rows", "splats"), default="rows",
        help="multi-device mode: 'rows' splits each view's tile rows over the ranks, "
        "'splats' the splats as well (1/N of the model a rank; cuda backend)")
    return parser


def _ranks(n_devices: int, dev: torch.device) -> tuple[int, bool]:
    """(ranks, joined): the number of ranks the run splits tile rows over,
    and whether this process joins a group a launcher set up rather than
    spawning its own."""
    if n_devices < 0:
        raise ValueError(f"--n_devices {n_devices}: give 0 (every GPU) or a count")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 or torch.distributed.is_initialized():
        distributed.initialize(dev)  # a no-op in a group already made
        world = torch.distributed.get_world_size()
        if n_devices not in (0, 1, world):  # 1, the default, defers to the launcher
            raise ValueError(f"--n_devices {n_devices} in a launched group of {world} ranks")
        return world, True
    if n_devices == 0:
        if dev.type != "cuda":
            raise ValueError("--n_devices 0 counts GPUs; on the CPU give the number of ranks")
        n_devices = torch.cuda.device_count()
    if n_devices > 1:
        distributed.rank_devices(n_devices, dev.type)  # raises with fewer GPUs than ranks
    return n_devices, False


def main(argv=None, device=None):
    """Parse `argv` (default: the command line) and train. Returns the
    Trainer, for a caller from Python; None from a run whose ranks it
    spawned (each rank held its own)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    model_p = cfg_lib.extract(cfg_lib.ModelParams, args)
    opt_p = cfg_lib.extract(cfg_lib.OptimizationParams, args)
    pipe_p = cfg_lib.extract(cfg_lib.PipelineParams, args)
    raster_p = cfg_lib.extract(cfg_lib.RasterParams, args)
    raster_p.backend = cfg_lib.port_backend(raster_p.backend)
    dev = default_device(device)
    n_ranks, joined = _ranks(args.n_devices, dev)
    if n_ranks > 1 and raster_p.backend == "oracle":
        raise ValueError("--backend oracle has no sharded form: train it with --n_devices 1")
    if n_ranks > 1 and args.shard_mode == "splats" and raster_p.backend != "cuda":
        raise ValueError(f"--shard_mode splats needs the cuda backend, not "
                         f"--backend {raster_p.backend}")

    if not model_p.model_path:
        model_p.model_path = os.path.join("./output", str(uuid.uuid4())[:10])
        args.model_path = model_p.model_path
    if distributed.is_primary():
        os.makedirs(model_p.model_path, exist_ok=True)
        cfg_lib.save_cfg_args(model_p.model_path, args)
        print(f"Output folder: {model_p.model_path}")
        if n_ranks > 1:
            mode = "splats and tile rows" if args.shard_mode == "splats" else "tile rows"
            print(f"Sharding {mode} over {n_ranks} ranks")

    if n_ranks > 1 and not joined:
        distributed.spawn(_train_rank, n_ranks, args=(model_p, opt_p, pipe_p, raster_p, args),
                          device=dev.type, timeout_s=None)
        return None
    mesh = distributed.make_mesh(n_ranks, dev) if joined else None
    return run_training(model_p, opt_p, pipe_p, raster_p, args,
                        mesh.device if mesh is not None else dev, mesh)


def _train_rank(mesh, model_p, opt_p, pipe_p, raster_p, args) -> None:
    """One spawned rank of `main`."""
    run_training(model_p, opt_p, pipe_p, raster_p, args, mesh.device, mesh)


def run_training(model_p, opt_p, pipe_p, raster_p, args, device, mesh=None):
    from tpu2dgs_torch.data.scene import Scene
    from tpu2dgs_torch.model import optim as optim_lib
    from tpu2dgs_torch.model import splats as splats_lib
    from tpu2dgs_torch.train import checkpoint as ckpt_lib
    from tpu2dgs_torch.train import losses
    from tpu2dgs_torch.train.logging import TrainLogger
    from tpu2dgs_torch.train.loop import TrainConfig, Trainer

    scene = Scene.load(
        model_p.source_path, images_dir=model_p.images,
        resolution=model_p.resolution,
        white_background=model_p.white_background,
        eval_split=model_p.eval, seed=args.seed,
        num_init_points=args.num_init_points,
    )
    primary = distributed.is_primary()
    # Fresh training only: persist input.ply + cameras.json into the model
    # dir (a resume must not clobber the original run's files with this
    # invocation's re-shuffled camera ordering).
    if not args.start_checkpoint and primary:
        scene.save_model_info(model_p.model_path)
    cam0 = scene.train_cameras[0]
    w, h = cam0.width, cam0.height
    if primary:
        print(f"{len(scene.train_cameras)} train / {len(scene.test_cameras)} test "
              f"cameras at {w}x{h}; extent {scene.extent:.2f}")

    train_cfg = TrainConfig(
        iterations=opt_p.iterations,
        lambda_dssim=opt_p.lambda_dssim,
        lambda_dist=opt_p.lambda_dist,
        lambda_normal=opt_p.lambda_normal,
        densify_from_iter=opt_p.densify_from_iter,
        densify_until_iter=opt_p.densify_until_iter,
        densification_interval=opt_p.densification_interval,
        opacity_reset_interval=opt_p.opacity_reset_interval,
        grad_threshold=opt_p.densify_grad_threshold,
        percent_dense=opt_p.percent_dense,
        opacity_cull=opt_p.opacity_cull,
        camera_batch=args.camera_batch,
    )
    opt_cfg = optim_lib.OptimConfig(
        position_lr_init=opt_p.position_lr_init,
        position_lr_final=opt_p.position_lr_final,
        position_lr_delay_mult=opt_p.position_lr_delay_mult,
        position_lr_max_steps=opt_p.position_lr_max_steps,
        feature_lr=opt_p.feature_lr,
        opacity_lr=opt_p.opacity_lr,
        scaling_lr=opt_p.scaling_lr,
        rotation_lr=opt_p.rotation_lr,
    )
    # Every knob a backend reads.
    raster_kwargs = dict(
        backend=raster_p.backend, tile_px=raster_p.tile_px,
        coarse_tiles=raster_p.coarse_tiles,
        bin_capacity=raster_p.bin_capacity,
        tile_capacity=raster_p.tile_capacity,
        col_capacity=raster_p.col_capacity,
        vis_capacity=raster_p.vis_capacity,
        grad_pack_capacity=raster_p.grad_pack_capacity,
        xfer_capacity=raster_p.xfer_capacity,
        chunk=raster_p.chunk,
        row_balance=raster_p.row_balance,
        depth_ratio=pipe_p.depth_ratio,
    )

    # Under splat sharding the whole model lies in host memory until the
    # Trainer keeps this rank's segment of it on the device.
    split = mesh is not None and args.shard_mode == "splats"
    whole_on = torch.device("cpu") if split else device
    start_step = 0
    if args.start_checkpoint:
        model, adam, start_step, _ = ckpt_lib.load_checkpoint(args.start_checkpoint,
                                                              device=whole_on)
        if primary:
            print(f"Resumed from {args.start_checkpoint} at step {start_step}")
    else:
        model = splats_lib.create_from_pcd(
            scene.points, scene.colors, sh_degree=model_p.sh_degree, device=whole_on)
        adam = None

    # Rank 0 alone logs and writes; the others train alike beside it.
    logger = TrainLogger(model_p.model_path) if primary else None

    def log_fn(it, metrics):
        if it % 10 == 0:
            logger.scalars(it, {
                "train_loss_patches/total_loss": metrics["loss"],
                "train_loss_patches/l1_loss": metrics["l1"],
                "train_loss_patches/normal_loss": metrics["normal"],
                "train_loss_patches/dist_loss": metrics["dist"],
                "num_visible": metrics["num_visible"],
                **({"perf/mpix_per_s": metrics["mpix_per_s"]}
                   if "mpix_per_s" in metrics else {}),
            })

    trainer = Trainer(
        model, scene.train_cameras, w, h,
        spatial_lr_scale=scene.extent, scene_extent=scene.extent,
        train_cfg=train_cfg, opt_cfg=opt_cfg, raster_kwargs=raster_kwargs,
        white_background=model_p.white_background,
        max_sh_degree=model_p.sh_degree, seed=args.seed,
        log_fn=log_fn if primary else None, max_capacity=args.max_capacity,
        mesh=mesh, shard_splats=args.shard_mode == "splats",
        profile_dir=args.profile_dir or None,
        gt_cache_mb=args.gt_cache_mb,
    )
    if args.start_checkpoint and adam is not None:
        if trainer.shard_splats:  # the whole checkpoint on every rank: keep the segment
            _, adam = sharded.shard_model_state(model, adam, mesh)
        trainer.adam = adam
        trainer.step = start_step
        trainer.active_sh_degree = min(
            start_step // train_cfg.sh_increment_interval, model_p.sh_degree)
    del model, adam  # under splat sharding the whole: the Trainer keeps its segment

    save_set = set(args.save_iterations)
    test_set = set(args.test_iterations)
    ckpt_set = set(args.checkpoint_iterations)
    block = 200

    # --detect_anomaly holds for this run only: the mode is put back after it.
    with contextlib.ExitStack() as stack:
        if logger is not None:
            stack.callback(logger.close)
        if not args.disable_viewer and mesh is not None:
            if primary:
                print("viewer not served under a mesh (a later slice of the port); "
                      "continuing without")
        elif not args.disable_viewer:
            from tpu2dgs_torch.viewer.network_gui import NetworkGUI

            gui = NetworkGUI(args.ip, args.port, device=device)
            stack.callback(gui.close)
            try:
                gui.init()
            except OSError as e:
                print(f"viewer server unavailable ({e}); continuing without")
            else:
                trainer.gui = gui
                trainer.source_path = model_p.source_path
        if args.detect_anomaly:
            stack.enter_context(torch.autograd.set_detect_anomaly(True))
        while trainer.step < opt_p.iterations:
            n = min(block, opt_p.iterations - trainer.step)
            # stop exactly at the next save/test/ckpt boundary
            boundaries = [i for i in (save_set | test_set | ckpt_set)
                          if trainer.step < i <= trainer.step + n]
            if boundaries:
                n = min(boundaries) - trainer.step
            trainer.train(num_iters=n, progress=not args.quiet and primary)
            it = trainer.step
            if it in test_set and (primary or trainer.shard_splats):  # every rank renders
                _test_report(trainer, scene, logger, losses, it, min(test_set))
            if it in save_set | ckpt_set:
                _write(trainer, it, it in save_set, it in ckpt_set, model_p.model_path)

    if primary:
        print("Training complete.")
    return trainer


def _write(trainer, it: int, save: bool, checkpoint: bool, model_path: str) -> None:
    """Rank 0 writes the whole model's PLY and/or checkpoint at iteration
    `it`. Under splat sharding every rank calls it: the whole model is
    gathered into rank 0's host memory and released when written."""
    from tpu2dgs_torch.model import splats as splats_lib
    from tpu2dgs_torch.train import checkpoint as ckpt_lib

    model, adam = trainer.whole_state()
    if not distributed.is_primary():
        return
    if save:
        out_dir = os.path.join(model_path, "point_cloud", f"iteration_{it}")
        os.makedirs(out_dir, exist_ok=True)
        splats_lib.save_ply(model, os.path.join(out_dir, "point_cloud.ply"))
        print(f"[ITER {it}] saved point cloud")
    if checkpoint:
        ckpt_lib.save_checkpoint(os.path.join(model_path, f"chkpnt{it}.npz"), model, adam, it)
        print(f"[ITER {it}] saved checkpoint")


@torch.no_grad()
def _test_report(trainer, scene, logger, losses, it: int, first_test_it: int) -> None:
    """The reference's training_report: L1 and PSNR of the test set and of
    a fixed slice of the train views, image panels of the first 5 views of
    each, the opacity histogram and the number of points, logged by rank 0
    (`logger` None elsewhere). Under splat sharding every rank calls it and
    renders each view with the others."""
    n_train = len(scene.train_cameras)
    configs = [
        ("test", scene.test_cameras),
        ("train", [scene.train_cameras[idx % n_train] for idx in range(5, 30, 5)]),
    ]
    for name, cams in configs:
        if not cams:
            continue
        l1s, psnrs = [], []
        for j, cam in enumerate(cams):
            out = trainer.render_view(cam)
            if logger is None:
                continue
            img = torch.clamp(out["render"], 0, 1)
            gtimg = torch.clamp(torch.from_numpy(np.asarray(cam.image, np.float32))
                                .to(img.device), 0, 1)
            l1s.append(float(losses.l1_loss(img, gtimg)))
            psnrs.append(float(losses.psnr(img, gtimg)))
            if j < 5:
                prefix = f"{name}_view_{cam.image_name}"
                logger.images(it, {f"{prefix}/{k}": v
                                   for k, v in logger.render_panels(out).items()})
                if it == first_test_it:
                    logger.images(it, {f"{prefix}/ground_truth": gtimg})
        if logger is None:
            continue
        l1_m, psnr_m = float(np.mean(l1s)), float(np.mean(psnrs))
        print(f"\n[ITER {it}] Evaluating {name}: L1 {l1_m:.5f} PSNR {psnr_m:.2f}")
        logger.scalars(it, {
            f"{name}/loss_viewpoint - l1_loss": l1_m,
            f"{name}/loss_viewpoint - psnr": psnr_m,
        })
    # the live splats' opacities: under splat sharding every rank's, at rank 0
    m = trainer.model
    opac_live = torch.stack([torch.sigmoid(m.params.opacity[:, 0]), m.live.float()], 1)
    if trainer.shard_splats:
        segs = distributed.gather_to_host(trainer.mesh, opac_live)
        opac_live = None if segs is None else torch.cat(segs)
    if logger is None:
        return
    opac = opac_live[:, 0][opac_live[:, 1] > 0]
    logger.histogram(it, "scene/opacity_histogram", opac)
    logger.scalars(it, {"total_points": int(opac.numel())})


if __name__ == "__main__":
    main()
