"""CLI configuration — flag-compatible with the reference's ParamGroups
(the port's copy of tpu2dgs/cli/config.py).

The reference builds argparse groups by reflection over class attributes
(arguments/__init__.py:19-45) and persists the merged namespace as a
`cfg_args` file that render/metrics re-load and overlay with CLI overrides
(arguments/__init__.py:97-117). Here the same surface is dataclasses with
explicit argparse registration: every reference flag exists with the same
name, shorthand, and default, and `cfg_args` round-trips in the identical
`Namespace(...)` repr format so the two implementations' model directories
are interchangeable.

The port's default rasterizer backend is "cuda", the JAX package's
"pallas" backend on another device: the same algorithm, capacities and
counters. `port_backend` reads "pallas" as "cuda" and says so; "tiled" and
"oracle" (the JAX package's default and its spec, plain PyTorch here) pass
through as they are.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import os
import sys
from typing import Optional


@dataclasses.dataclass
class ModelParams:
    """Reference arguments/__init__.py:47-63."""

    sh_degree: int = 3
    source_path: str = ""      # -s
    model_path: str = ""       # -m
    images: str = "images"     # -i
    resolution: int = -1       # -r
    white_background: bool = False  # -w
    data_device: str = "cuda"  # accepted for compatibility; ignored
    eval: bool = False

    _SHORT = {"source_path": "-s", "model_path": "-m", "images": "-i",
              "resolution": "-r", "white_background": "-w"}


@dataclasses.dataclass
class PipelineParams:
    """Reference arguments/__init__.py:65-71."""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    depth_ratio: float = 0.0
    debug: bool = False


@dataclasses.dataclass
class OptimizationParams:
    """Reference arguments/__init__.py:73-95."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    lambda_dist: float = 0.0
    lambda_normal: float = 0.05
    opacity_cull: float = 0.05
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002


@dataclasses.dataclass
class RasterParams:
    """Rasterizer knobs (no reference counterpart).

    The capacity knobs are INITIAL values — the Trainer's adaptive cap
    growth, and cli.render's and cli.view's renders, raise any of them
    whose overflow counter fires (raster/capacity.py). tile_px,
    coarse_tiles and chunk belong to the tiled backend (chunk to the
    oracle too); row_balance and xfer_capacity to
    multi-device rendering: those two flags parse, as the JAX package's do,
    and nothing on one device reads them."""

    backend: str = "cuda"
    tile_px: int = 16
    coarse_tiles: int = 4
    bin_capacity: int = 4096
    tile_capacity: int = 512
    col_capacity: int = 32768
    vis_capacity: int = 0
    grad_pack_capacity: int = 0
    chunk: int = 32
    row_balance: str = "work"   # multi-device strip assignment: "work"
                                # (traced work-quantile windows) | "static"
    xfer_capacity: int = 0      # splat sharding: strip-routed all_to_all
                                # survivor exchange rows per owner->strip
                                # message (0 = all-gather path)


def port_backend(name: str) -> str:
    """The port's backend for a backend name from a flag or a cfg_args."""
    if name in ("cuda", "tiled", "oracle"):
        return name
    if name == "pallas":
        print('backend "pallas" (the JAX package\'s fused kernels) read as "cuda": '
              "the same algorithm and contract on the GPU")
        return "cuda"
    raise ValueError(f"unknown raster backend {name!r}")


def add_group(parser: argparse.ArgumentParser, cls, sentinel: bool = False):
    """Register one dataclass as an argparse group. With `sentinel`, every
    default becomes None so cfg_args values win unless the flag was given
    (reference ParamGroup(parser, fill_none=True) semantics)."""
    group = parser.add_argument_group(cls.__name__)
    short = getattr(cls, "_SHORT", {})
    for f in dataclasses.fields(cls):
        names = ["--" + f.name]
        if f.name in short:
            names.insert(0, short[f.name])
        default = None if sentinel else f.default
        if f.type in ("bool", bool):
            group.add_argument(*names, action="store_true", default=default)
        else:
            ty = {int: int, float: float, str: str}.get(
                eval(f.type) if isinstance(f.type, str) else f.type, str
            )
            group.add_argument(*names, type=ty, default=default)
    return group


def extract(cls, args: argparse.Namespace):
    """Build a dataclass from the merged namespace."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if hasattr(args, f.name) and getattr(args, f.name) is not None:
            kwargs[f.name] = getattr(args, f.name)
    return cls(**kwargs)


def save_cfg_args(model_path: str, args: argparse.Namespace) -> None:
    """Persist the reference-format cfg_args (train.py:181-182)."""
    os.makedirs(model_path, exist_ok=True)
    model_fields = {f.name for f in dataclasses.fields(ModelParams)}
    ns = argparse.Namespace(
        **{k: v for k, v in vars(args).items() if k in model_fields}
    )
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(repr(ns))


def load_cfg_args(model_path: str) -> argparse.Namespace:
    """Parse a cfg_args file — accepts this package's, the JAX package's and the
    reference's output (a `Namespace(k=v, ...)` repr). Values are parsed
    with ast.literal_eval instead of the reference's bare eval()."""
    with open(os.path.join(model_path, "cfg_args")) as f:
        text = f.read().strip()
    if not (text.startswith("Namespace(") and text.endswith(")")):
        raise ValueError(f"{model_path}/cfg_args is not a Namespace(...) repr")
    inner = text[len("Namespace("):-1]
    # parse as keyword args of a call
    call = ast.parse(f"f({inner})", mode="eval").body
    kwargs = {kw.arg: ast.literal_eval(kw.value) for kw in call.keywords}
    if "backend" in kwargs:  # a hand-written file may carry the JAX package's name
        kwargs["backend"] = port_backend(kwargs["backend"])
    return argparse.Namespace(**kwargs)


def get_combined_args(parser: argparse.ArgumentParser,
                      argv: Optional[list[str]] = None) -> argparse.Namespace:
    """CLI args overlaid on the model dir's persisted cfg_args
    (reference arguments/__init__.py:97-117)."""
    args_cmdline = parser.parse_args(argv if argv is not None else sys.argv[1:])
    merged = vars(args_cmdline).copy()
    try:
        cfg = load_cfg_args(args_cmdline.model_path)
        for k, v in vars(cfg).items():
            if merged.get(k) is None:
                merged[k] = v
    except (OSError, ValueError):
        print("cfg_args not found; using CLI arguments only")
    return argparse.Namespace(**merged)
