"""Per-splat preprocessing: world -> screen surfel transforms (port of
tpu2dgs/raster/preprocess.py).

A surfel maps (u, v, 1) in its tangent plane to homogeneous pixel
coordinates (x*w, y*w, w) through the 3x3 matrix

    T = splat2world[[u-axis, v-axis, center]] @ world2pix[:, [x, y, w]]

Column j of T is the coefficient vector a_j with (u,v,1)·a_0 = x*w etc.,
and w equals the view-space depth of the plane point. Plain PyTorch,
vectorized over splats: elementwise work that needs no kernel of its own.

The projected center is an explicit intermediate (`mean2d`), with T's
third row reparametrized as ((mean2d + offset) * w, w), so a gradient
w.r.t. `offset` is the screen-space densification gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu2dgs_torch.core import sh as sh_lib
from tpu2dgs_torch.core import transforms
from tpu2dgs_torch.core.cameras import CameraArrays, ndc_to_pix
from tpu2dgs_torch.raster.common import (ALPHA_MIN, CUTOFF, FILTER_INV_SQUARE,
                                         MIN_RADIUS, NEAR_CULL)


class SplatScreen(NamedTuple):
    """Per-splat screen-space quantities consumed by the blend backend."""

    tmat: torch.Tensor      # (N,3,3) rows [u; v; center]: (u,v,1)@tmat = (xw, yw, w)
    color: torch.Tensor     # (N,3) RGB from SH at the center view direction
    opacity: torch.Tensor   # (N,) activated opacity
    normal: torch.Tensor    # (N,3) view-space unit normal, flipped toward camera
    mean2d: torch.Tensor    # (N,2) projected center (pixel coords)
    filter_center: torch.Tensor  # (N,2) CUTOFF-conic AABB center: the
                            # low-pass circle center used by rho2d
    depth: torch.Tensor     # (N,) view-space center depth (sort key); +inf if culled
    radius: torch.Tensor    # (N,) int32 screen radius in pixels; 0 if culled
    half_extent: torch.Tensor  # (N,2) per-axis CUTOFF-conic half extents
    box_center: torch.Tensor   # (N,2) binning AABB center: the union of the
    box_half: torch.Tensor     # (N,2) te2-conic box and the low-pass circle box
    te2: torch.Tensor       # (N,) adaptive conic tau^2 for binning
    fr2: torch.Tensor       # (N,) low-pass circle radius^2 for binning
    visible: torch.Tensor   # (N,) bool


def conic_bounds(tmat: torch.Tensor, tau2=None):
    """Screen AABB of the projected tau-sigma disk (default tau = CUTOFF).

    Extremes of x = (a1·m)/(a3·m) over the homogeneous conic u^2+v^2 = tau^2
    (dual conic D = diag(tau^2, tau^2, -1)):
      center = (a1^T D a3) / (a3^T D a3),
      half_extent^2 = center^2 - (a1^T D a1)/(a3^T D a3).

    tau2: () or (N,) conic level; None = CUTOFF^2.
    Returns (center (N,2), half_extent (N,2), valid (N,))."""
    a1 = tmat[..., :, 0]
    a2 = tmat[..., :, 1]
    a3 = tmat[..., :, 2]
    c2 = CUTOFF * CUTOFF if tau2 is None else tau2
    c2 = torch.as_tensor(c2, dtype=tmat.dtype, device=tmat.device).expand(tmat.shape[:-2])
    d = torch.stack([c2, c2, -torch.ones_like(c2)], dim=-1)

    def quad(x, y):
        return torch.sum(x * d * y, dim=-1)

    denom = quad(a3, a3)
    valid = torch.abs(denom) > 1e-12
    safe = torch.where(valid, denom, 1.0)
    cx = quad(a1, a3) / safe
    cy = quad(a2, a3) / safe
    ex2 = cx * cx - quad(a1, a1) / safe
    ey2 = cy * cy - quad(a2, a2) / safe
    center = torch.stack([cx, cy], dim=-1)
    half_extent = torch.sqrt(torch.clamp(torch.stack([ex2, ey2], dim=-1), min=1e-4))
    return center, half_extent, valid


def preprocess(
    xyz: torch.Tensor,          # (N,3)
    scaling: torch.Tensor,      # (N,2) activated (exp) scales
    rotation: torch.Tensor,     # (N,4) raw wxyz quaternion
    opacity: torch.Tensor,      # (N,) activated (sigmoid) opacity
    features: torch.Tensor,     # (N,K,3) SH coefficients (dc first)
    cam: CameraArrays,
    width: int,
    height: int,
    sh_degree: int,
    mean2d_offset: torch.Tensor | None = None,  # (N,2) zeros; grad = means2D.grad
    scale_modifier: float = 1.0,
    live: torch.Tensor | None = None,           # (N,) bool mask for padded slots
    override_color: torch.Tensor | None = None,  # (N,3)
    axes_override=None,  # (tu, tv, tw) each (N,3): precomputed splat2world basis
) -> SplatScreen:
    n = xyz.shape[0]
    if mean2d_offset is None:
        mean2d_offset = torch.zeros((n, 2), dtype=torch.float32, device=xyz.device)

    if axes_override is not None:
        tu, tv, tw = axes_override
        tu = tu * scale_modifier
        tv = tv * scale_modifier
    else:
        tu, tv, tw = transforms.splat_axes(scaling * scale_modifier, rotation)

    world2pix = cam.full_proj @ ndc_to_pix(width, height, cam.znear, cam.zfar)
    wp = world2pix[:, [0, 1, 3]]  # (4,3): world -> (xw, yw, w)

    row_u = tu @ wp[:3, :]                       # directions: no translation
    row_v = tv @ wp[:3, :]
    row_c = transforms.homogenize(xyz) @ wp      # (N,3) homogeneous pixel center

    # View-space center & frustum cull.
    p_view = transforms.homogenize(xyz) @ cam.world_view
    z = p_view[:, 2]
    in_front = z > NEAR_CULL

    # Differentiable screen center (reparametrized third row).
    wc = row_c[:, 2]
    safe_wc = torch.where(torch.abs(wc) > 1e-12, wc, 1.0)
    mean2d = row_c[:, :2] / safe_wc[:, None]
    row_c = torch.cat([(mean2d + mean2d_offset) * wc[:, None], wc[:, None]], dim=-1)

    tmat = torch.stack([row_u, row_v, row_c], dim=-2)  # (N,3,3)

    # Screen bounds (non-differentiable: binning / visibility only).
    center, half_extent, conic_ok = conic_bounds(tmat.detach())
    radius_f = torch.clamp(torch.amax(half_extent, dim=-1), min=MIN_RADIUS)
    radius = torch.ceil(radius_f).to(torch.int32)

    # Opacity-adaptive coverage bounds for binning: a pixel blends only if
    # alpha = opacity*exp(-rho/2) >= ALPHA_MIN, so the conic never matters
    # past tau_a^2 = 2 ln(opacity/ALPHA_MIN). Both levels are inflated by a
    # small margin so the f32 coverage test can only err conservative.
    op_sg = opacity.detach()
    tau_a2 = 2.0 * torch.log(torch.clamp(op_sg, min=1e-12) / ALPHA_MIN)
    te2 = torch.clamp(tau_a2, 1e-6, CUTOFF * CUTOFF) * 1.001 + 1e-5
    fr2 = torch.clamp(tau_a2, min=1e-6) / FILTER_INV_SQUARE * 1.001 + 1e-5
    a_center, a_half, a_ok = conic_bounds(tmat.detach(), te2)
    fr = torch.sqrt(fr2)[:, None]
    legacy_half = torch.clamp(half_extent, min=MIN_RADIUS)
    lo = torch.where(a_ok[:, None],
                     torch.minimum(a_center - a_half, center - fr),
                     center - legacy_half)
    hi = torch.where(a_ok[:, None],
                     torch.maximum(a_center + a_half, center + fr),
                     center + legacy_half)
    # never wider than the legacy CUTOFF box (it bounds the full hit set)
    lo = torch.maximum(lo, center - legacy_half)
    hi = torch.minimum(hi, center + legacy_half)
    box_center = 0.5 * (lo + hi)
    box_half = 0.5 * (hi - lo)

    # Cull splats whose AABB misses the screen entirely.
    on_screen = (
        (center[:, 0] + radius_f >= 0.0)
        & (center[:, 0] - radius_f <= width - 1)
        & (center[:, 1] + radius_f >= 0.0)
        & (center[:, 1] - radius_f <= height - 1)
    )

    visible = in_front & conic_ok & on_screen
    if live is not None:
        visible = visible & live
    radius = torch.where(visible, radius, 0)
    depth = torch.where(visible, z, torch.inf)

    if override_color is not None:
        color = override_color
    else:
        dirs = transforms.normalize(xyz - cam.cam_center[None, :])
        shs = torch.swapaxes(features, -1, -2)  # (N,3,K)
        color = torch.clamp(sh_lib.eval_sh(sh_degree, shs, dirs) + 0.5, min=0.0)

    # View-space normal flipped to face the camera (dual-visible surfels).
    n_view = tw @ cam.world_view[:3, :3]
    facing = torch.sum(p_view[:, :3] * n_view, dim=-1)
    n_view = torch.where(facing[:, None] < 0.0, n_view, -n_view)

    return SplatScreen(
        tmat=tmat,
        color=color,
        opacity=opacity,
        normal=n_view,
        mean2d=mean2d,
        filter_center=center.detach(),
        depth=depth,
        radius=radius,
        half_extent=legacy_half,
        box_center=box_center,
        box_half=box_half,
        te2=te2,
        fr2=fr2,
        visible=visible,
    )
