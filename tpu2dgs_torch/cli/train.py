"""Training from the command line — flag-compatible with the JAX package's
`tpu2dgs.cli.train` and the reference train.py.

    python3 -m tpu2dgs_torch.cli.train -s <data> -m <output> [--iterations 30000] ...

Runs on the GPU. `main(argv, device="cpu")` from Python runs the kernels'
plain versions on the CPU, as the tests do; there is no flag for it.

Not ported yet, and said so rather than passed over: `--n_devices` other
than 1 and `--shard_mode splats` raise NotImplementedError (the
multi-device slice); the training viewer is absent, so without
`--disable_viewer` the run prints that and goes on without one.
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
        help="devices to shard rendering over; only 1 is ported")
    parser.add_argument(
        "--profile_dir", type=str, default="",
        help="capture a torch.profiler trace of training steps 100-110 into "
        "this directory (a Chrome trace)")
    parser.add_argument(
        "--shard_mode", choices=("rows", "splats"), default="rows",
        help="multi-device mode; only 'rows' on one device is ported")
    return parser


def main(argv=None, device=None):
    """Parse `argv` (default: the command line) and train. Returns the
    Trainer, for a caller from Python."""
    parser = build_parser()
    args = parser.parse_args(argv)
    model_p = cfg_lib.extract(cfg_lib.ModelParams, args)
    opt_p = cfg_lib.extract(cfg_lib.OptimizationParams, args)
    pipe_p = cfg_lib.extract(cfg_lib.PipelineParams, args)
    raster_p = cfg_lib.extract(cfg_lib.RasterParams, args)
    raster_p.backend = cfg_lib.port_backend(raster_p.backend)
    if args.n_devices != 1 or args.shard_mode == "splats":
        raise NotImplementedError(
            f"--n_devices {args.n_devices} --shard_mode {args.shard_mode}: multi-device "
            "training is not ported yet (it comes with the multi-device slice); "
            "run with --n_devices 1 --shard_mode rows")
    dev = default_device(device)

    if not model_p.model_path:
        model_p.model_path = os.path.join("./output", str(uuid.uuid4())[:10])
        args.model_path = model_p.model_path
    os.makedirs(model_p.model_path, exist_ok=True)
    cfg_lib.save_cfg_args(model_p.model_path, args)
    print(f"Output folder: {model_p.model_path}")

    return run_training(model_p, opt_p, pipe_p, raster_p, args, dev)


def run_training(model_p, opt_p, pipe_p, raster_p, args, device):
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
    # Fresh training only: persist input.ply + cameras.json into the model
    # dir (a resume must not clobber the original run's files with this
    # invocation's re-shuffled camera ordering).
    if not args.start_checkpoint:
        scene.save_model_info(model_p.model_path)
    cam0 = scene.train_cameras[0]
    w, h = cam0.width, cam0.height
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
    # What the cuda backend on one device reads; the tiled backend's and the
    # multi-device knobs of RasterParams parse and are not passed on.
    raster_kwargs = dict(
        backend=raster_p.backend,
        bin_capacity=raster_p.bin_capacity,
        tile_capacity=raster_p.tile_capacity,
        col_capacity=raster_p.col_capacity,
        vis_capacity=raster_p.vis_capacity,
        grad_pack_capacity=raster_p.grad_pack_capacity,
        depth_ratio=pipe_p.depth_ratio,
    )

    start_step = 0
    if args.start_checkpoint:
        model, adam, start_step, _ = ckpt_lib.load_checkpoint(args.start_checkpoint,
                                                              device=device)
        print(f"Resumed from {args.start_checkpoint} at step {start_step}")
    else:
        model = splats_lib.create_from_pcd(
            scene.points, scene.colors, sh_degree=model_p.sh_degree, device=device)
        adam = None

    logger = TrainLogger(model_p.model_path)

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
        log_fn=log_fn, max_capacity=args.max_capacity,
        profile_dir=args.profile_dir or None,
        gt_cache_mb=args.gt_cache_mb,
    )
    if not args.disable_viewer:
        print("viewer server unavailable (the training viewer is not ported yet); "
              "continuing without")

    if args.start_checkpoint and adam is not None:
        trainer.adam = adam
        trainer.step = start_step
        trainer.active_sh_degree = min(
            start_step // train_cfg.sh_increment_interval, model_p.sh_degree)

    save_set = set(args.save_iterations)
    test_set = set(args.test_iterations)
    ckpt_set = set(args.checkpoint_iterations)
    block = 200

    # --detect_anomaly holds for this run only: the mode is put back after it.
    with contextlib.ExitStack() as stack:
        stack.callback(logger.close)
        if args.detect_anomaly:
            stack.enter_context(torch.autograd.set_detect_anomaly(True))
        while trainer.step < opt_p.iterations:
            n = min(block, opt_p.iterations - trainer.step)
            # stop exactly at the next save/test/ckpt boundary
            boundaries = [i for i in (save_set | test_set | ckpt_set)
                          if trainer.step < i <= trainer.step + n]
            if boundaries:
                n = min(boundaries) - trainer.step
            trainer.train(num_iters=n, progress=not args.quiet)
            it = trainer.step

            if it in test_set:
                _test_report(trainer, scene, logger, losses, it, min(test_set))
            if it in save_set:
                out_dir = os.path.join(model_p.model_path, "point_cloud", f"iteration_{it}")
                os.makedirs(out_dir, exist_ok=True)
                splats_lib.save_ply(trainer.model, os.path.join(out_dir, "point_cloud.ply"))
                print(f"[ITER {it}] saved point cloud")
            if it in ckpt_set:
                ckpt_lib.save_checkpoint(
                    os.path.join(model_p.model_path, f"chkpnt{it}.npz"),
                    trainer.model, trainer.adam, it)
                print(f"[ITER {it}] saved checkpoint")

    print("Training complete.")
    return trainer


@torch.no_grad()
def _test_report(trainer, scene, logger, losses, it: int, first_test_it: int) -> None:
    """The reference's training_report: L1 and PSNR of the test set and of
    a fixed slice of the train views, image panels of the first 5 views of
    each, the opacity histogram and the number of points."""
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
        l1_m, psnr_m = float(np.mean(l1s)), float(np.mean(psnrs))
        print(f"\n[ITER {it}] Evaluating {name}: L1 {l1_m:.5f} PSNR {psnr_m:.2f}")
        logger.scalars(it, {
            f"{name}/loss_viewpoint - l1_loss": l1_m,
            f"{name}/loss_viewpoint - psnr": psnr_m,
        })
    model = trainer.model
    opac = torch.sigmoid(model.params.opacity[:, 0])[model.live]
    logger.histogram(it, "scene/opacity_histogram", opac)
    logger.scalars(it, {"total_points": int(model.num_live())})


if __name__ == "__main__":
    main()
