"""Oracle rasterizer: every splat against every pixel, plain PyTorch (port
of tpu2dgs/raster/oracle.py).

O(N * pixels): the executable spec every fast backend is held against.
Differentiable and without binning: the splats are depth-sorted once and
composited chunk by chunk over the whole pixel grid with the shared blend
math (raster/blend.py). No kernel: the JAX oracle reaches no
pl.pallas_call, so this runs on the caller's device as the JAX oracle runs
on XLA.
"""

from __future__ import annotations

import torch

from tpu2dgs_torch.raster import blend
from tpu2dgs_torch.raster.preprocess import SplatScreen


def rasterize_oracle(splats: SplatScreen, width: int, height: int,
                     bg_color: torch.Tensor, chunk: int = 64):
    """Returns (image (H,W,3), allmap dict of (H,W[,3]) tensors)."""
    n = splats.tmat.shape[0]
    dev = splats.tmat.device
    pad = (-n) % chunk
    # stable: equal depths keep id order, and culled splats (+inf) land last
    order = torch.argsort(splats.depth.detach(), stable=True)
    if pad:
        order = torch.cat([order, order.new_zeros(pad)])
    num_chunks = (n + pad) // chunk
    order = order.reshape(num_chunks, chunk)
    valid = torch.arange(num_chunks * chunk, device=dev).reshape(num_chunks, chunk) < n

    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    px = xs.reshape(-1)
    py = ys.reshape(-1)

    def body(state, ids, ok):
        alpha, depth, contrib = blend.splat_pixel_response(
            splats.tmat[ids], splats.filter_center[ids], splats.opacity[ids], px, py)
        contrib = contrib & (ok & splats.visible[ids])[:, None]
        return blend.blend_chunk(
            state, alpha, depth, contrib, splats.color[ids], splats.normal[ids])

    state = blend.init_state(width * height, dtype=splats.tmat.dtype, device=dev)
    state = blend.scan_chunks(body, state, zip(order, valid))

    color, maps = blend.finalize(state, bg_color)
    image = color.reshape(height, width, 3)
    allmap = {k: v.reshape(height, width, *v.shape[1:]) for k, v in maps.items()}
    return image, allmap
