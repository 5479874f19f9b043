"""DTU full-evaluation harness (port of scripts/dtu_eval.py).

    python3 -m tpu2dgs_torch.eval.dtu_eval --dtu <dir> --DTU_Official <dir>
        [--output_path P] [--skip_training] [--skip_rendering] [--skip_metrics]

15 scans trained at -r 2 with --depth_ratio 1 and --lambda_dist 1000
(30,000 steps); cli.render meshes each (voxel 0.004, sdf_trunc 0.016,
depth_trunc 3, one cluster); `eval.dtu_scene` scores each mesh's Chamfer
distance against the official points with mask culling, writing
results.json beside the scan's model, where `eval.summary` reads it (the
script writes it under scripts/tmp, where its summary never looks). Each
stage is a process of its own (`sys.executable -m tpu2dgs_torch...`) on
the GPU; a stage that fails raises, naming its command. The datasets are
not in the repository.
"""

from __future__ import annotations

import subprocess
import sys
from argparse import ArgumentParser

from tpu2dgs_torch import default_device

SCANS = ["scan24", "scan37", "scan40", "scan55", "scan63", "scan65",
         "scan69", "scan83", "scan97", "scan105", "scan106", "scan110",
         "scan114", "scan118", "scan122"]
TRAIN = [sys.executable, "-m", "tpu2dgs_torch.cli.train"]
RENDER = [sys.executable, "-m", "tpu2dgs_torch.cli.render"]
SCORE = [sys.executable, "-m", "tpu2dgs_torch.eval.dtu_scene"]


def main(argv=None, device=None) -> None:
    default_device(device)
    parser = ArgumentParser(description="Full evaluation script parameters")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="./eval/dtu")
    parser.add_argument("--dtu", "-dtu", type=str, default=None)
    parser.add_argument("--DTU_Official", "-DTU", type=str, default=None)
    args = parser.parse_args(argv)

    if not args.skip_training:
        common = ["--quiet", "--test_iterations", "30000", "--depth_ratio", "1.0", "-r", "2",
                  "--lambda_dist", "1000"]
        for scan in SCANS:
            subprocess.run([*TRAIN, "-s", f"{args.dtu}/{scan}",
                            "-m", f"{args.output_path}/{scan}", *common], check=True)

    if not args.skip_rendering:
        common = ["--quiet", "--skip_train", "--depth_ratio", "1.0", "--num_cluster", "1",
                  "--voxel_size", "0.004", "--sdf_trunc", "0.016", "--depth_trunc", "3.0"]
        for scan in SCANS:
            subprocess.run([*RENDER, "--iteration", "30000", "-s", f"{args.dtu}/{scan}",
                            "-m", f"{args.output_path}/{scan}", *common], check=True)

    if not args.skip_metrics:
        for scan in SCANS:
            subprocess.run([
                *SCORE,
                "--input_mesh", f"{args.output_path}/{scan}/train/ours_30000/fuse_post.ply",
                "--scan_id", scan[4:], "--output_dir", f"{args.output_path}/{scan}",
                "--mask_dir", f"{args.dtu}", "--DTU", f"{args.DTU_Official}"], check=True)


if __name__ == "__main__":
    main()
