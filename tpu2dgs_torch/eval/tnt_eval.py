"""Tanks and Temples full-evaluation harness (port of scripts/tnt_eval.py).

    python3 -m tpu2dgs_torch.eval.tnt_eval --TNT_data <dir> --TNT_GT <dir>
        [--output_path P] [--skip_training] [--skip_rendering] [--skip_metrics]

6 scenes trained at -r 2 with --depth_ratio 1 (30,000 steps); cli.render
meshes the 360 scenes at voxel 0.004 and the large ones at 0.006;
`eval.tnt_scene` scores each mesh's F-score at the scene's threshold after
the official trajectory alignment and crop, writing f1.json beside the
scene's model. The reference prints --lambda_dist 100 / 10 for training
but its executed command drops it, and so does the script: the default
lambda_dist trains here too. Each stage is a process of its own
(`sys.executable -m tpu2dgs_torch...`) on the GPU; a stage that fails
raises, naming its command. The datasets are not in the repository.
"""

from __future__ import annotations

import os
import subprocess
import sys
from argparse import ArgumentParser

from tpu2dgs_torch import default_device

TNT_360 = ["Barn", "Caterpillar", "Ignatius", "Truck"]
TNT_LARGE = ["Meetingroom", "Courthouse"]
# per-scene F-score distance thresholds (the reference's eval_tnt config)
TAU = {"Barn": 0.01, "Caterpillar": 0.005, "Ignatius": 0.003,
       "Truck": 0.005, "Meetingroom": 0.01, "Courthouse": 0.025}
TRAIN = [sys.executable, "-m", "tpu2dgs_torch.cli.train"]
RENDER = [sys.executable, "-m", "tpu2dgs_torch.cli.render"]
SCORE = [sys.executable, "-m", "tpu2dgs_torch.eval.tnt_scene"]


def main(argv=None, device=None) -> None:
    default_device(device)
    parser = ArgumentParser(description="Full evaluation script parameters")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="eval/tnt")
    parser.add_argument("--TNT_data", type=str, default=None)
    parser.add_argument("--TNT_GT", type=str, default=None)
    args = parser.parse_args(argv)

    if not args.skip_training:
        common = ["--quiet", "--test_iterations", "30000", "--depth_ratio", "1.0", "-r", "2"]
        for scene in TNT_360 + TNT_LARGE:
            subprocess.run([*TRAIN, "-s", f"{args.TNT_data}/{scene}",
                            "-m", f"{args.output_path}/{scene}", *common], check=True)

    if not args.skip_rendering:
        common = ["--quiet", "--depth_ratio", "1.0", "--num_cluster", "1"]
        for scenes, mesh in ((TNT_360, ["--voxel_size", "0.004", "--sdf_trunc", "0.016",
                                        "--depth_trunc", "3.0"]),
                             (TNT_LARGE, ["--voxel_size", "0.006", "--sdf_trunc", "0.024",
                                          "--depth_trunc", "4.5"])):
            for scene in scenes:
                subprocess.run([*RENDER, "--iteration", "30000", "-s", f"{args.TNT_data}/{scene}",
                                "-m", f"{args.output_path}/{scene}", *common, *mesh],
                               check=True)

    if not args.skip_metrics:
        for scene in TNT_360 + TNT_LARGE:
            gt = f"{args.TNT_GT}/{scene}"
            # The official protocol's inputs: the ground truth's COLMAP
            # trajectory, its alignment and crop volume; the estimated
            # trajectory is the model directory's cameras.json.
            extra = ["--traj-path", f"{args.output_path}/{scene}/cameras.json",
                     "--gt-log", f"{gt}/{scene}_COLMAP_SfM.log",
                     "--gt-trans", f"{gt}/{scene}_trans.txt",
                     "--crop-json", f"{gt}/{scene}.json"]
            mapping = f"{gt}/{scene}_mapping_reference.txt"
            if os.path.exists(mapping):
                extra += ["--map-file", mapping]
            subprocess.run([*SCORE, "--gt-ply", f"{gt}/{scene}.ply",
                            "--ply-path",
                            f"{args.output_path}/{scene}/train/ours_30000/fuse_post.ply",
                            "--tau", str(TAU[scene]),
                            "--out", f"{args.output_path}/{scene}/f1.json", *extra], check=True)


if __name__ == "__main__":
    main()
