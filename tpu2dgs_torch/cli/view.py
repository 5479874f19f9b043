"""Serve a trained model to the remote viewer from the command line — the
counterpart of the JAX package's `tpu2dgs.cli.view` (`tpu2dgs-view`) and
the reference view.py.

    python3 -m tpu2dgs_torch.cli.view -m <model dir> [--iteration N] [--ip 127.0.0.1 --port 6009]

Loads <model>/point_cloud/iteration_<N>/point_cloud.ply (default: the
latest) onto the GPU and answers viewer requests over the network_gui
protocol forever: each request is rendered at the client's resolution and
scaling modifier (the cuda backend: K1 three times, K2 once a render), put
through the chosen render mode and sent back as u8 bytes. The capacity
flags are initial values: a frame whose lists overflow is rendered again at
grown capacities, which later frames keep (raster/capacity.py). Waiting for a
client blocks on the listening socket. `main(argv, device="cpu")` from
Python serves through the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import os
import select

import torch

from tpu2dgs_torch import default_device
from tpu2dgs_torch.cli import config as cfg_lib
from tpu2dgs_torch.cli.render import latest_iteration
from tpu2dgs_torch.model import splats as splats_lib
from tpu2dgs_torch.raster.api import RasterSettings, render
from tpu2dgs_torch.raster.capacity import CapacityHealer
from tpu2dgs_torch.viewer.network_gui import NetworkGUI


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="tpu2dgs_torch viewer server")
    cfg_lib.add_group(parser, cfg_lib.ModelParams, sentinel=True)
    cfg_lib.add_group(parser, cfg_lib.PipelineParams)
    cfg_lib.add_group(parser, cfg_lib.RasterParams)
    # a backend stored in cfg_args wins over the default unless --backend is given
    parser.set_defaults(backend=None)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--ip", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    return parser


class ModelView:
    """A loaded model rendered for the viewer at whatever resolution and
    scaling modifier a request asks for, under no_grad: `render` is what
    `NetworkGUI.serve` calls for a frame. Its capacities heal
    (`self.healer`, which grows them in `self.settings`)."""

    def __init__(self, model: splats_lib.SplatModel, settings: dict, bg: torch.Tensor,
                 verify: str = ""):
        self.model = model
        self.settings = settings   # RasterSettings fields but width, height, scale_modifier
        self.healer = CapacityHealer(settings)
        self.bg = bg
        self.verify = verify       # the string sent back with every frame
        self.metrics = {"#": int(model.num_live())}
        p = model.params
        self.splat_args = (p.xyz, torch.exp(p.scaling), p.rotation,
                           torch.sigmoid(p.opacity[:, 0]), splats_lib.features(p))

    @torch.no_grad()
    def render(self, cam, width: int, height: int, scaling_modifier: float) -> dict:
        return self.healer.render(lambda caps: render(
            cam, RasterSettings(width=width, height=height,
                                scale_modifier=float(scaling_modifier), **caps),
            *self.splat_args, self.bg, live=self.model.live, device=self.bg.device))


def open_model(argv=None, device=None) -> tuple[ModelView, argparse.Namespace]:
    """Parse `argv` (default: the command line) and load the model it names
    onto `device` (default: the GPU)."""
    args = cfg_lib.get_combined_args(build_parser(), argv)
    model_p = cfg_lib.extract(cfg_lib.ModelParams, args)
    pipe_p = cfg_lib.extract(cfg_lib.PipelineParams, args)
    raster_p = cfg_lib.extract(cfg_lib.RasterParams, args)
    dev = default_device(device)
    it = args.iteration if args.iteration != -1 else latest_iteration(model_p.model_path)
    ply = os.path.join(model_p.model_path, "point_cloud", f"iteration_{it}", "point_cloud.ply")
    model = splats_lib.load_ply(ply, sh_degree=model_p.sh_degree, device=dev)
    settings = dict(
        sh_degree=model_p.sh_degree, depth_ratio=pipe_p.depth_ratio,
        backend=cfg_lib.port_backend(raster_p.backend), tile_px=raster_p.tile_px,
        coarse_tiles=raster_p.coarse_tiles, bin_capacity=raster_p.bin_capacity,
        tile_capacity=raster_p.tile_capacity, col_capacity=raster_p.col_capacity,
        chunk=raster_p.chunk)
    bg = (torch.ones if model_p.white_background else torch.zeros)(
        3, dtype=torch.float32, device=dev)
    return ModelView(model, settings, bg, verify=model_p.source_path or ""), args


def main(argv=None, device=None):
    view, args = open_model(argv, device)
    gui = NetworkGUI(args.ip, args.port, device=view.bg.device)
    gui.init()
    print(f"viewer server on {args.ip}:{args.port} ({view.metrics['#']} splats)")
    try:
        while True:
            if gui.conn is None:
                select.select([gui.listener], [], [])  # wait for a client
                gui.try_connect()
                continue
            try:
                gui.serve(view.render, view.verify, view.metrics)
            except (ConnectionError, OSError):
                gui.disconnect()
    finally:
        gui.close()


if __name__ == "__main__":
    main()
