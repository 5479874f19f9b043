"""Renderer API — the reference `render()` contract (port of
tpu2dgs/raster/api.py).

Same output dictionary as the JAX package (render, rend_alpha,
rend_normal, rend_dist, surf_depth, surf_normal, depth_expected,
depth_median, radii, visibility_filter, mean2d, plus the backend's
overflow counters) with CHW image layouts and the same allmap decoding.

Backends: "cuda" (the counterpart of the JAX "pallas" backend: the select
kernel and the forward and backward blend kernels). "oracle" and "tiled"
are named for parity and raise NotImplementedError until they are ported,
as do `mesh=` and `shard_splats=`.

`render` is differentiable with respect to xyz, scaling, rotation,
opacity, features and `mean2d_offset`, whichever of them require grad. A
caller that only serves wraps the call in torch.no_grad(): then nothing
is kept for a backward pass.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpu2dgs_torch import default_device
from tpu2dgs_torch.core import sh as sh_lib
from tpu2dgs_torch.core import transforms
from tpu2dgs_torch.core.cameras import CameraArrays, depth_to_normal
from tpu2dgs_torch.raster import preprocess as pre
from tpu2dgs_torch.raster.cuda_backend import rasterize_cuda

BACKENDS = ("cuda", "oracle", "tiled")


@dataclasses.dataclass(frozen=True)
class RasterSettings:
    """Static rasterization configuration."""

    width: int
    height: int
    sh_degree: int = 3
    depth_ratio: float = 0.0
    backend: str = "cuda"
    scale_modifier: float = 1.0
    bin_capacity: int = 4096     # max splats per coarse bin
    tile_capacity: int = 1024    # max splats per fine tile
    col_capacity: int = 32768    # binning L1: max splats per BX-wide screen
                                 # column (overflow drops the DEEPEST
                                 # candidates; see col_overflow_frac)
    vis_capacity: int = 0        # depth-compaction prefix size (0 = all N)
    grad_pack_capacity: int = 0  # backward packed gradient rows (0 = 16 *
                                 # tile_capacity * image tile columns);
                                 # reported by grad_pack_overflow_frac

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown raster backend {self.backend!r}")


def render(
    cam: CameraArrays,
    settings: RasterSettings,
    xyz: torch.Tensor,
    scaling: torch.Tensor,
    rotation: torch.Tensor,
    opacity: torch.Tensor,
    features: torch.Tensor,
    bg_color: torch.Tensor,
    mean2d_offset: Optional[torch.Tensor] = None,
    live: Optional[torch.Tensor] = None,
    override_color: Optional[torch.Tensor] = None,
    mesh=None,
    shard_splats: bool = False,
    convert_shs_python: bool = False,
    compute_cov3d_python: bool = False,
    axes_override=None,
    device=None,
    plain: bool = False,
):
    """Render one view. Returns the reference-contract dict.

    Inputs are moved to `device` (default CUDA; raises without a GPU
    unless device="cpu" is passed). `convert_shs_python` /
    `compute_cov3d_python` evaluate SH->RGB and the splat tangent axes
    outside preprocess and feed them back through `override_color` /
    `axes_override`, as the reference PipelineParams do. `plain=True`
    runs the kernels' plain PyTorch versions, forward and backward, on
    any device: what the kernels are held against."""
    if mesh is not None or shard_splats:
        raise NotImplementedError("multi-device rendering is not ported yet")
    if settings.backend != "cuda":
        raise NotImplementedError(f"the {settings.backend!r} backend is not ported yet")
    dev = default_device(device)

    def on(x):
        return None if x is None else x.to(dev)

    cam = cam.to(dev)
    xyz, scaling, rotation, features, bg_color = map(
        on, (xyz, scaling, rotation, features, bg_color))
    opacity = on(opacity).reshape(-1)
    mean2d_offset, live, override_color = map(on, (mean2d_offset, live, override_color))
    if axes_override is not None:
        axes_override = tuple(map(on, axes_override))

    if compute_cov3d_python and axes_override is None:
        # preprocess applies scale_modifier to override axes itself
        axes_override = transforms.splat_axes(scaling, rotation)
    if convert_shs_python and override_color is None:
        dirs = transforms.normalize(xyz - cam.cam_center[None, :])
        shs = torch.swapaxes(features, -1, -2)
        override_color = pre.clamp_color(sh_lib.eval_sh(settings.sh_degree, shs, dirs) + 0.5)

    w, h = settings.width, settings.height
    splats = pre.preprocess(
        xyz, scaling, rotation, opacity, features, cam, w, h, settings.sh_degree,
        mean2d_offset=mean2d_offset, scale_modifier=settings.scale_modifier,
        live=live, override_color=override_color, axes_override=axes_override)

    image, allmap = rasterize_cuda(splats, settings, bg_color, plain=plain)
    aux = {k: allmap.pop(k) for k in list(allmap) if k.startswith("_aux_")}
    out = decode_outputs(cam, settings, splats, image, allmap)
    for k, v in aux.items():
        out[k.removeprefix("_aux_")] = v
    return out


def mark_visible(xyz: torch.Tensor, cam: CameraArrays, near: float = 0.2) -> torch.Tensor:
    """(N,) bool frustum visibility of positions (the reference
    GaussianRasterizer.markVisible contract)."""
    p_view = transforms.homogenize(xyz) @ cam.world_view
    z = p_view[:, 2]
    clip = transforms.homogenize(xyz) @ cam.full_proj
    w = torch.where(torch.abs(clip[:, 3]) > 1e-12, clip[:, 3], 1.0)
    ndc = clip[:, :2] / w[:, None]
    margin = 1.3  # the reference culls conservatively beyond ~1.3x frustum
    return (z > near) & (torch.abs(ndc[:, 0]) < margin) & (torch.abs(ndc[:, 1]) < margin)


def decode_outputs(cam: CameraArrays, settings: RasterSettings, splats, image, allmap):
    """allmap -> the reference render-pkg dict."""
    w, h = settings.width, settings.height

    alpha = allmap["alpha"]  # (H,W)
    # View -> world normal rotation (left unnormalized: magnitude = alpha weight).
    rend_normal = allmap["normal"] @ cam.world_view[:3, :3].T  # (H,W,3)

    depth_median = allmap["depth_median"]
    safe_alpha = torch.where(alpha > 0.0, alpha, 1.0)
    depth_expected = torch.where(alpha > 0.0, allmap["depth_expected"] / safe_alpha, 0.0)

    surf_depth = depth_expected * (1.0 - settings.depth_ratio) + settings.depth_ratio * depth_median

    surf_normal = depth_to_normal(cam, surf_depth, w, h)  # (H,W,3) world
    surf_normal = surf_normal * alpha.detach()[..., None]

    def chw(x):
        return x.permute(2, 0, 1)

    return {
        "render": chw(image),                      # (3,H,W)
        "rend_alpha": alpha[None],                 # (1,H,W)
        "rend_normal": chw(rend_normal),           # (3,H,W)
        "rend_dist": allmap["distortion"][None],   # (1,H,W)
        "surf_depth": surf_depth[None],            # (1,H,W)
        "surf_normal": chw(surf_normal),           # (3,H,W)
        "depth_expected": depth_expected[None],
        "depth_median": depth_median[None],
        "radii": splats.radius,                    # (N,) int32
        "visibility_filter": splats.radius > 0,    # (N,) bool
        "mean2d": splats.mean2d,                   # (N,2) projected centers
    }
