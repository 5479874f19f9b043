"""Where a mesh run's time goes on the GPU, against the number of views.

    python3 -m tpu2dgs_torch.eval.mesh_profile [--views 3,24,96] [--mesh_res 1024] [--unbounded]

Meshes the shell scene of chip_smoke.py (eval.synthetic.make_shell_scene:
800x800, 131,072 splats, the bench capacities) from N orbit views
(synthetic.shell_camera, evenly spaced) the way cli.render's mesh branch
does: a diffuse render (SH degree 0) of every view into
GaussianExtractor.reconstruction, then cli.render.extract_mesh at the
command line's defaults for --mesh_res (bounded, or contracted with
--unbounded), post-processing and the PLY writes included. Prints one JSON
line per view count with

  * `seconds`: reconstruction, the extraction and inside it fusion and
    marching, post-processing and the PLY writes, each call between two
    synchronizes; `extract_rest` is the extraction less fusion and
    marching (the grids' host copies, the unbounded grid's points, the
    vertex colours); `fusion_per_view`;
  * `peak_device_bytes`: the most allocated during the run above what was
    allocated before it, and `map_bytes`, what the kept maps take;
  * the fused and post-processed meshes' vertex and face counts;

then one line with the card's name and power limit. Needs a CUDA device;
the kernels build on first use.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from tpu2dgs_torch import default_device
from tpu2dgs_torch.cli import render as cli_render
from tpu2dgs_torch.eval import synthetic
from tpu2dgs_torch.eval.timing import Stopwatch, card
from tpu2dgs_torch.mesh import extract, marching, tsdf
from tpu2dgs_torch.raster import api

W = H = 800
N_SPLATS = 1 << 17
CAPS = dict(bin_capacity=8192, tile_capacity=2048, col_capacity=32768)


def mesh_run(scene, n_views: int, mesh_res: int, unbounded: bool, w: int = W, h: int = H,
             device=None, **caps) -> dict:
    """One mesh run of `scene` ((xyz, scaling, rotation, opacity, features),
    activated) from `n_views` orbit views; returns its measurements."""
    dev = default_device(device)
    on_gpu = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_gpu else (lambda: None)
    settings = api.RasterSettings(w, h, sh_degree=0, **caps)
    bg = torch.zeros(3, device=dev)
    cams = []
    for k in range(n_views):
        cam = synthetic.shell_camera(2 * np.pi * (0.13 + k / n_views), w, h)
        cam.uid, cam.image_name = k, f"shell{k}"
        cams.append(cam)

    def render_fn(cam):
        return api.render(cam.arrays(dev), settings, *scene, bg, device=dev)

    argv = ["-m", "unused", "--mesh_res", str(mesh_res)] + (["--unbounded"] if unbounded else [])
    args = cli_render.build_parser().parse_args(argv)
    fuse = (extract, "_fuse_world_slab") if unbounded else (tsdf, "integrate")
    extract_fn = "extract_mesh_unbounded" if unbounded else "extract_mesh_bounded"
    watch, written, extractors = Stopwatch(sync), {}, []
    write = extract.write_mesh_ply

    def write_and_keep(path, verts, faces, colors=None):
        written["post" if path.endswith("_post.ply") else "fused"] = {
            "vertices": len(verts), "faces": len(faces)}
        write(path, verts, faces, colors)

    reconstruction = extract.GaussianExtractor.reconstruction

    def keep_extractor(self, cameras):
        extractors.append(self)
        return reconstruction(self, cameras)

    sync()
    if on_gpu:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir, contextlib.ExitStack() as stack:
        stack.enter_context(torch.no_grad())
        stack.enter_context(mock.patch.object(extract, "write_mesh_ply", write_and_keep))
        stack.enter_context(mock.patch.object(extract.GaussianExtractor, "reconstruction",
                                              keep_extractor))
        for owner, fn, label in (  # each wraps what is patched above
                (extract.GaussianExtractor, "reconstruction", "reconstruction"),
                (extract.GaussianExtractor, extract_fn, "extract"), (*fuse, "fusion"),
                (marching, "marching_tetrahedra", "marching"),
                (extract, "post_process_mesh", "post_process"),
                (extract, "write_mesh_ply", "write_ply")):
            stack.enter_context(watch.watch(owner, fn, label))
        cli_render.extract_mesh(args, cams, render_fn, out_dir, dev)
    sync()
    total_s = time.perf_counter() - t0
    seconds = watch.totals()
    seconds["extract_rest"] = seconds["extract"] - seconds["fusion"] - seconds["marching"]
    seconds["fusion_per_view"] = seconds["fusion"] / n_views
    ex = extractors[0]
    maps = ex.rgbmaps + ex.depthmaps + ex.alphamaps
    return {"views": n_views, "mesh_res": mesh_res, "unbounded": unbounded,
            "width": w, "height": h, "splats": int(scene[0].shape[0]),
            "seconds": seconds, "total_seconds": total_s,
            "peak_device_bytes": torch.cuda.max_memory_allocated() - base if on_gpu else None,
            "map_bytes": sum(m.numel() * m.element_size() for m in maps),
            "radius": ex.radius, **written}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--views", default="3,24,96",
                        help="comma-separated view counts, one mesh run each")
    parser.add_argument("--mesh_res", default=1024, type=int)
    parser.add_argument("--unbounded", action="store_true")
    args = parser.parse_args(argv)
    dev = default_device(None)
    _, scene = synthetic.make_shell_scene(W, H, N_SPLATS, seed=0, device=dev)
    for n in (int(v) for v in args.views.split(",")):
        print(json.dumps(mesh_run(scene, n, args.mesh_res, args.unbounded, device=dev,
                                  **CAPS)), flush=True)
    print(json.dumps({"card": card()}))


if __name__ == "__main__":
    main()
