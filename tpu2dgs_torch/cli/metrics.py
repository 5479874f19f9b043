"""Image-quality evaluation over rendered test sets from the command line
— the counterpart of the JAX package's `tpu2dgs.cli.metrics` and the
reference metrics.py.

    python3 -m tpu2dgs_torch.cli.metrics -m <model dir> [--no_lpips]

Walks <model>/test/ours_*/{renders,gt}, computes per-view SSIM and PSNR
(train/losses.py) and, unless --no_lpips is given, LPIPS (eval/lpips.py),
and writes results.json and per_view.json. LPIPS needs its weights file,
which is not in the repository: where it is missing the command says that
LPIPS is unavailable and writes null, as the JAX package does.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from tpu2dgs_torch import default_device


def _load_image_chw(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
    return arr.transpose(2, 0, 1)


@torch.no_grad()
def evaluate_dir(method_dir: str, use_lpips: bool = True, device=None):
    from tpu2dgs_torch.train import losses

    dev = default_device(device)
    renders_dir = os.path.join(method_dir, "renders")
    gt_dir = os.path.join(method_dir, "gt")
    names = sorted(os.listdir(renders_dir))

    lpips = None
    if use_lpips:
        from tpu2dgs_torch.eval import lpips as lpips_lib

        try:
            lpips = lpips_lib.lpips_fn(device=dev)
        except FileNotFoundError as e:  # no weights: any other failure is raised
            print(f"  (LPIPS unavailable: {e})")

    ssims, psnrs, lpipss = [], [], []
    per_view = {"SSIM": {}, "PSNR": {}, "LPIPS": {}}
    for name in names:
        r = torch.from_numpy(_load_image_chw(os.path.join(renders_dir, name))).to(dev)
        g = torch.from_numpy(_load_image_chw(os.path.join(gt_dir, name))).to(dev)
        s = float(losses.ssim(r, g))
        p = float(losses.psnr(r, g))
        ssims.append(s)
        psnrs.append(p)
        per_view["SSIM"][name] = s
        per_view["PSNR"][name] = p
        if lpips is not None:
            v = float(lpips(r, g))
            lpipss.append(v)
            per_view["LPIPS"][name] = v
    summary = {
        "SSIM": float(np.mean(ssims)),
        "PSNR": float(np.mean(psnrs)),
        "LPIPS": float(np.mean(lpipss)) if lpipss else None,
    }
    return summary, per_view


def evaluate(model_paths: list[str], use_lpips: bool = True, device=None):
    for model_path in model_paths:
        print("Scene:", model_path)
        full_dict, per_view_dict = {}, {}
        test_dir = os.path.join(model_path, "test")
        try:
            methods = sorted(os.listdir(test_dir))
        except OSError as e:
            print(f"Unable to compute metrics for model {model_path}: {e}")
            continue
        for method in methods:
            print("Method:", method)
            summary, per_view = evaluate_dir(os.path.join(test_dir, method), use_lpips,
                                             device=device)
            full_dict[method] = summary
            per_view_dict[method] = per_view
            print(f"  SSIM : {summary['SSIM']:.7f}")
            print(f"  PSNR : {summary['PSNR']:.7f}")
            if summary["LPIPS"] is not None:
                print(f"  LPIPS: {summary['LPIPS']:.7f}")
        with open(os.path.join(model_path, "results.json"), "w") as f:
            json.dump(full_dict, f, indent=True)
        with open(os.path.join(model_path, "per_view.json"), "w") as f:
            json.dump(per_view_dict, f, indent=True)


def main(argv=None, device=None):
    parser = argparse.ArgumentParser(description="tpu2dgs_torch metrics")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+")
    parser.add_argument("--no_lpips", action="store_true")
    args = parser.parse_args(argv)
    evaluate(args.model_paths, use_lpips=not args.no_lpips, device=device)


if __name__ == "__main__":
    main()
