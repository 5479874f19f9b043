"""MipNeRF-360 full-evaluation harness (port of scripts/m360_eval.py).

    python3 -m tpu2dgs_torch.eval.m360_eval --mipnerf360 <dir> [--output_path P]
        [--skip_training] [--skip_rendering] [--skip_metrics]

9 scenes: the outdoor ones trained at images_4, the indoor ones at
images_2, 30,000 steps each; then cli.render of the test views without the
mesh and cli.metrics over all of them. Each stage is a process of its own
(`sys.executable -m tpu2dgs_torch.cli.*`) on the GPU; a stage that fails
raises, naming its command. The dataset is not in the repository.
"""

from __future__ import annotations

import subprocess
import sys
from argparse import ArgumentParser

from tpu2dgs_torch import default_device

OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
INDOOR = ["room", "counter", "kitchen", "bonsai"]
TRAIN = [sys.executable, "-m", "tpu2dgs_torch.cli.train"]
RENDER = [sys.executable, "-m", "tpu2dgs_torch.cli.render"]
METRICS = [sys.executable, "-m", "tpu2dgs_torch.cli.metrics"]


def main(argv=None, device=None) -> None:
    default_device(device)
    parser = ArgumentParser(description="Full evaluation script parameters")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="eval/mipnerf360")
    parser.add_argument("--mipnerf360", "-m360", type=str, default=None)
    args = parser.parse_args(argv)
    scenes = OUTDOOR + INDOOR

    if not args.skip_training:
        common = ["--quiet", "--eval", "--test_iterations", "30000"]
        for images, group in (("images_4", OUTDOOR), ("images_2", INDOOR)):
            for scene in group:
                subprocess.run([*TRAIN, "-s", f"{args.mipnerf360}/{scene}", "-i", images,
                                "-m", f"{args.output_path}/{scene}", *common], check=True)

    if not args.skip_rendering:
        common = ["--quiet", "--eval", "--skip_train", "--skip_mesh"]
        for scene in scenes:
            subprocess.run([*RENDER, "--iteration", "30000", "-s", f"{args.mipnerf360}/{scene}",
                            "-m", f"{args.output_path}/{scene}", *common], check=True)

    if not args.skip_metrics:
        subprocess.run([*METRICS, "-m", *(f"{args.output_path}/{s}" for s in scenes)],
                       check=True)


if __name__ == "__main__":
    main()
