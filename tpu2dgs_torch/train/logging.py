"""Training observability: TensorBoard scalars/images and a JSONL metrics
file (port of tpu2dgs/train/logging.py).

Reference train.py:114-118,194-248 (SummaryWriter scalars per iteration,
image panels at test iterations) and utils/general_utils.py:113-128 (the
timestamped stdout decorator of safe_state). TensorBoard is optional: the
JSONL metrics file is always written, and it is all there is where
TensorBoard does not import.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch


def _np(a) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class TrainLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.writer = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(log_dir)
            except ImportError:
                pass  # no tensorboard package: JSONL only
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()

    def scalars(self, step: int, values: dict) -> None:
        clean = {}
        for k, v in values.items():
            try:
                clean[k] = float(v)
            except (TypeError, ValueError):
                continue
        if self.writer is not None:
            for k, v in clean.items():
                self.writer.add_scalar(k, v, step)
        clean["step"] = step
        clean["wall_s"] = round(time.time() - self._t0, 3)
        self._jsonl.write(json.dumps(clean) + "\n")
        self._jsonl.flush()

    def histogram(self, step: int, name: str, values) -> None:
        """TB histogram (reference train.py's scene/opacity_histogram);
        the JSONL fallback records summary quantiles."""
        values = _np(values)
        if values.size == 0:
            return
        if self.writer is not None:
            self.writer.add_histogram(name, values, step)
        self.scalars(step, {
            f"{name}/mean": float(values.mean()),
            f"{name}/p10": float(np.percentile(values, 10)),
            f"{name}/p90": float(np.percentile(values, 90)),
        })

    def images(self, step: int, panels: dict) -> None:
        """panels: name -> (C,H,W) float array in [0,1]."""
        if self.writer is None:
            return
        for name, img in panels.items():
            self.writer.add_image(
                name, np.clip(_np(img), 0, 1), step)

    def render_panels(self, render_pkg: dict) -> dict:
        """The reference's tb image panel set (train.py:214-238)."""
        depth = _np(render_pkg["surf_depth"])[0]
        lo, hi = depth.min(), depth.max()
        depth_vis = (depth - lo) / max(hi - lo, 1e-12)
        return {
            "render": _np(render_pkg["render"]),
            "alpha": _np(render_pkg["rend_alpha"]),
            "normal": (_np(render_pkg["rend_normal"]) + 1) / 2,
            "surf_normal": (_np(render_pkg["surf_normal"]) + 1) / 2,
            "depth": depth_vis[None],
            "distortion": _np(render_pkg["rend_dist"]),
        }

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
        self._jsonl.close()
