"""NeRF-synthetic full-evaluation harness (port of scripts/nerf_eval.py).

    python3 -m tpu2dgs_torch.eval.nerf_eval --nerf_synthetic <dir> [--output_path P]
        [--parallel N] [--skip_training] [--skip_rendering] [--skip_metrics]

The 8 scenes on a white background at lambda_normal 0: cli.train of every
scene (30,000 steps), then cli.render of the test views without the mesh,
then cli.metrics over all of them, each stage a process of its own
(`sys.executable -m tpu2dgs_torch.cli.*`). Up to N training jobs run at
once; job i is pinned to GPU i mod the GPU count through
CUDA_VISIBLE_DEVICES (a list the caller set is taken as the pool). A stage
that fails raises, naming its command. The dataset is not in the
repository.
"""

from __future__ import annotations

import os
import subprocess
import sys
from argparse import ArgumentParser
from concurrent.futures import ThreadPoolExecutor

import torch

from tpu2dgs_torch import default_device

SCENES = ["chair", "drums", "ficus", "hotdog", "lego", "materials", "mic", "ship"]
TRAIN = [sys.executable, "-m", "tpu2dgs_torch.cli.train"]
RENDER = [sys.executable, "-m", "tpu2dgs_torch.cli.render"]
METRICS = [sys.executable, "-m", "tpu2dgs_torch.cli.metrics"]


def gpu_pool() -> list[str]:
    """The CUDA_VISIBLE_DEVICES value of each GPU jobs are pinned to: the
    caller's own list when set, else every device."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    if visible.strip():
        return [d.strip() for d in visible.split(",") if d.strip()]
    return [str(i) for i in range(torch.cuda.device_count())]


def main(argv=None, device=None) -> None:
    default_device(device)
    parser = ArgumentParser(description="Full evaluation script parameters")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="eval/nerf_synthetic")
    parser.add_argument("--nerf_synthetic", "-ns", type=str, default=None)
    parser.add_argument("--parallel", type=int, default=1,
                        help="concurrent scene jobs (1 per GPU)")
    args = parser.parse_args(argv)

    jobs = []
    if not args.skip_training:
        common = ["--quiet", "--eval", "-w", "--lambda_normal", "0.0",
                  "--test_iterations", "30000"]
        for scene in SCENES:
            jobs.append([*TRAIN, "-s", f"{args.nerf_synthetic}/{scene}",
                         "-m", f"{args.output_path}/{scene}", *common])
    if jobs:
        pool = gpu_pool()
        if not pool:
            raise RuntimeError("nerf_eval: no GPU to pin the training jobs to")

        def train(job):
            i, cmd = job
            env = dict(os.environ, CUDA_VISIBLE_DEVICES=pool[i % len(pool)])
            subprocess.run(cmd, check=True, env=env)

        with ThreadPoolExecutor(max_workers=max(1, args.parallel)) as ex:
            list(ex.map(train, enumerate(jobs)))

    if not args.skip_rendering:
        common = ["--quiet", "--eval", "--skip_train", "--skip_mesh"]
        for scene in SCENES:
            subprocess.run([*RENDER, "--iteration", "30000",
                            "-s", f"{args.nerf_synthetic}/{scene}",
                            "-m", f"{args.output_path}/{scene}", *common], check=True)

    if not args.skip_metrics:
        subprocess.run([*METRICS, "-m", *(f"{args.output_path}/{s}" for s in SCENES)],
                       check=True)


if __name__ == "__main__":
    main()
