"""COLMAP preprocessing for raw image folders (the port's copy of
tpu2dgs/cli/convert.py).

    python3 -m tpu2dgs_torch.cli.convert -s <folder with input/>

Reference convert.py:35-122: shells out to colmap feature_extractor /
exhaustive_matcher / mapper / image_undistorter (+ optional downscales).
Process-level orchestration only; requires the `colmap` binary on PATH.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys


def _run(cmd: str) -> None:
    print(f"+ {cmd}")
    code = subprocess.call(cmd, shell=True)
    if code != 0:
        print(f"command failed with code {code}; aborting")
        sys.exit(code)


def main(argv=None, device=None):
    del device  # COLMAP runs as its own processes
    parser = argparse.ArgumentParser(description="COLMAP converter")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--camera", default="OPENCV")
    parser.add_argument("--colmap_executable", default="")
    parser.add_argument("--resize", action="store_true")
    parser.add_argument("--magick_executable", default="")
    args = parser.parse_args(argv)

    colmap = args.colmap_executable or "colmap"
    magick = args.magick_executable or "magick"
    use_gpu = 0 if args.no_gpu else 1
    src = args.source_path

    if not args.skip_matching:
        os.makedirs(os.path.join(src, "distorted", "sparse"), exist_ok=True)
        _run(
            f'{colmap} feature_extractor '
            f'--database_path {src}/distorted/database.db '
            f'--image_path {src}/input '
            f'--ImageReader.single_camera 1 '
            f'--ImageReader.camera_model {args.camera} '
            f'--SiftExtraction.use_gpu {use_gpu}'
        )
        _run(
            f'{colmap} exhaustive_matcher '
            f'--database_path {src}/distorted/database.db '
            f'--SiftMatching.use_gpu {use_gpu}'
        )
        _run(
            f'{colmap} mapper '
            f'--database_path {src}/distorted/database.db '
            f'--image_path {src}/input '
            f'--output_path {src}/distorted/sparse '
            f'--Mapper.ba_global_function_tolerance=0.000001'
        )

    _run(
        f'{colmap} image_undistorter '
        f'--image_path {src}/input '
        f'--input_path {src}/distorted/sparse/0 '
        f'--output_path {src} --output_type COLMAP'
    )

    sparse0 = os.path.join(src, "sparse", "0")
    os.makedirs(sparse0, exist_ok=True)
    for f in os.listdir(os.path.join(src, "sparse")):
        full = os.path.join(src, "sparse", f)
        if os.path.isfile(full):
            shutil.move(full, os.path.join(sparse0, f))

    if args.resize:
        for factor, name in ((2, "images_2"), (4, "images_4"), (8, "images_8")):
            dst = os.path.join(src, name)
            os.makedirs(dst, exist_ok=True)
            for f in os.listdir(os.path.join(src, "images")):
                src_f = os.path.join(src, "images", f)
                dst_f = os.path.join(dst, f)
                shutil.copy2(src_f, dst_f)
                _run(f'{magick} mogrify -resize {100 / factor}% {dst_f}')
    print("Done.")


if __name__ == "__main__":
    main()
