"""Front-to-back surfel alpha blending: the shared compositing math of the
oracle and tiled backends (port of tpu2dgs/raster/blend.py).

  * perspective-correct ray-splat intersection: for pixel (x,y) the plane
    constraints k = x*a3 - a1 and l = y*a3 - a2 intersect in splat-local
    coordinates (u,v,1) ~ k x l; rho3d = u^2 + v^2,
  * screen-space low-pass: rho2d = 2 * |pix - filter_center|^2 (no gradient),
  * rho = min(rho3d, rho2d); alpha = min(0.99, opacity * exp(-rho/2)),
  * skip alpha < 1/255; a splat that would drop transmittance below 1e-4 is
    not blended and terminates the pixel for good (sticky done flag),
  * median depth = intersection depth of the last blended splat with
    pre-blend transmittance > 0.5,
  * depth distortion accumulated pairwise-incrementally over NDC-mapped
    depth m = far*(t-near)/((far-near)*t), near=0.2, far=100.

A chunk of S splats against P pixels is dense (S,P) arithmetic; the
front-to-back order dependence is closed-form through exclusive cumulative
products and sums along S, as in the JAX package: the same float function
as there, not a serial per-splat loop. Every function takes any leading
batch dimensions (the tiled backend's tiles) before S and P.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from tpu2dgs_torch.raster.common import (
    ALPHA_CLAMP,
    ALPHA_MIN,
    CUTOFF,
    DIST_FAR,
    DIST_NEAR,
    FILTER_INV_SQUARE,
    INTERSECT_NEAR,
    MEDIAN_T,
    T_EPS,
)


class PixelState(NamedTuple):
    """Per-pixel compositing state; every field has shape (..., P) or (..., P, 3)."""

    transmittance: torch.Tensor
    done: torch.Tensor          # bool: sticky early-termination flag
    color: torch.Tensor         # (..., P, 3)
    depth: torch.Tensor         # alpha-weighted expected depth (unnormalized)
    normal: torch.Tensor        # (..., P, 3) alpha-weighted view-space normal
    median: torch.Tensor
    m1: torch.Tensor            # sum w*m   (distortion accumulators)
    m2: torch.Tensor            # sum w*m^2
    distortion: torch.Tensor


def init_state(shape, dtype=torch.float32, device=None) -> PixelState:
    """The empty state of `shape` pixels (an int P or a tuple (..., P))."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)

    def z(*tail):
        return torch.zeros((*shape, *tail), dtype=dtype, device=device)

    return PixelState(
        transmittance=torch.ones(shape, dtype=dtype, device=device),
        done=torch.zeros(shape, dtype=torch.bool, device=device),
        color=z(3), depth=z(), normal=z(3), median=z(), m1=z(), m2=z(),
        distortion=z(),
    )


def splat_pixel_response(tmat, filter_center, opacity, px, py):
    """Alpha and intersection depth of S splats at P pixels.

    Args:
      tmat: (..., S, 3, 3) splat -> homogeneous-pixel transforms.
      filter_center: (..., S, 2) screen centers of the low-pass term.
      opacity: (..., S)
      px, py: (..., P) pixel coordinates.

    Returns alpha (..., S, P), depth (..., S, P), contrib (..., S, P) bool.
    """
    a1 = tmat[..., 0][..., None, :]  # (..., S, 1, 3)
    a2 = tmat[..., 1][..., None, :]
    a3 = tmat[..., 2][..., None, :]
    pix = torch.stack([px, py], dim=-1)[..., None, :, :]  # (..., 1, P, 2)

    k = pix[..., 0:1] * a3 - a1  # (..., S, P, 3)
    m = pix[..., 1:2] * a3 - a2
    # p = k x m (homogeneous intersection point in splat-local coords)
    p_u = k[..., 1] * m[..., 2] - k[..., 2] * m[..., 1]
    p_v = k[..., 2] * m[..., 0] - k[..., 0] * m[..., 2]
    p_w = k[..., 0] * m[..., 1] - k[..., 1] * m[..., 0]
    valid = p_w != 0.0
    inv_w = torch.where(valid, 1.0, 0.0) / torch.where(valid, p_w, 1.0)
    su = p_u * inv_w
    sv = p_v * inv_w
    rho3d = su * su + sv * sv

    d = filter_center.detach()[..., :, None, :] - pix
    rho2d = FILTER_INV_SQUARE * torch.sum(d * d, dim=-1)
    rho = torch.where(rho3d <= rho2d, rho3d, rho2d)

    depth = su * a3[..., 0] + sv * a3[..., 1] + a3[..., 2]

    alpha = torch.clamp(opacity[..., None] * torch.exp(-0.5 * rho), max=ALPHA_CLAMP)
    # CUTOFF-sigma truncation of the conic path: a pixel responds only inside
    # the projected 3-sigma disk or inside the low-pass footprint, the set the
    # binning boxes bound exactly.
    inside = (rho3d <= CUTOFF * CUTOFF) | (rho2d <= rho3d)
    contrib = valid & inside & (depth >= INTERSECT_NEAR) & (alpha >= ALPHA_MIN)
    return alpha, depth, contrib


def map_depth(t: torch.Tensor) -> torch.Tensor:
    """NDC-map depth to [0,1] for the distortion loss (near 0.2, far 100)."""
    safe = torch.clamp(t, min=1e-6)
    return DIST_FAR * (safe - DIST_NEAR) / ((DIST_FAR - DIST_NEAR) * safe)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along S (dim -2); 0 where there is none, as
    jnp.argmax of a bool array: torch.argmax returns the first maximum."""
    return torch.argmax(mask.to(torch.uint8), dim=-2)


def blend_chunk(state: PixelState, alpha, depth, contrib, color, normal) -> PixelState:
    """Composite a depth-ordered chunk of S splats into the pixel state.

    alpha, depth, contrib: (..., S, P); color, normal: (..., S, 3).
    Equivalent to the serial front-to-back loop, splat by splat; the serial
    dependence is closed-form through exclusive cumprod/cumsum along S."""
    s = alpha.shape[-2]
    contrib = contrib & ~state.done[..., None, :]
    a = torch.where(contrib, alpha, 0.0)

    one_minus = 1.0 - a
    # Exclusive cumulative transmittance within the chunk; a <= 0.99, so
    # 1 - a >= 0.01 and the division is safe.
    cum_excl = torch.cumprod(one_minus, dim=-2) / one_minus
    t_before = state.transmittance[..., None, :] * cum_excl  # (..., S, P)

    test_t = t_before * one_minus
    kill = contrib & (test_t < T_EPS)
    has_kill = torch.any(kill, dim=-2)
    first_kill = torch.where(has_kill, _first_true(kill), s)  # (..., P)
    idx = torch.arange(s, device=alpha.device)[:, None]
    blended = contrib & (idx < first_kill[..., None, :])

    w = torch.where(blended, a * t_before, 0.0)  # (..., S, P)

    # Distortion (exclusive prefix sums of w*m and w*m^2).
    m = map_depth(depth)
    wm = w * m
    wm2 = w * m * m
    m1_before = state.m1[..., None, :] + torch.cumsum(wm, dim=-2) - wm
    m2_before = state.m2[..., None, :] + torch.cumsum(wm2, dim=-2) - wm2
    acc_before = 1.0 - t_before
    dist_e = w * (m * m * acc_before + m2_before - 2.0 * m * m1_before)

    # Median depth: the last blended splat with pre-blend T > 0.5.
    med_cand = blended & (t_before > MEDIAN_T)
    any_med = torch.any(med_cand, dim=-2)
    last_med = s - 1 - _first_true(torch.flip(med_cand, dims=(-2,)))  # (..., P)
    med_depth = torch.gather(depth, -2, last_med[..., None, :])[..., 0, :]
    median = torch.where(any_med, med_depth, state.median)

    t_out = state.transmittance * torch.prod(torch.where(blended, one_minus, 1.0), dim=-2)

    return PixelState(
        transmittance=t_out,
        done=state.done | has_kill,
        color=state.color + torch.einsum("...sp,...sc->...pc", w, color),
        depth=state.depth + torch.sum(w * depth, dim=-2),
        normal=state.normal + torch.einsum("...sp,...sc->...pc", w, normal),
        median=median,
        m1=state.m1 + torch.sum(wm, dim=-2),
        m2=state.m2 + torch.sum(wm2, dim=-2),
        distortion=state.distortion + torch.sum(dist_e, dim=-2),
    )


def finalize(state: PixelState, bg_color: torch.Tensor):
    """Composite the background; return (color (..., P, 3), allmap dict of
    (..., P) / (..., P, 3))."""
    color = state.color + state.transmittance[..., None] * bg_color
    alpha = 1.0 - state.transmittance
    return color, {
        "depth_expected": state.depth,   # unnormalized
        "alpha": alpha,
        "normal": state.normal,          # view space, alpha-weighted
        "depth_median": state.median,
        "distortion": state.distortion,
    }


def scan_chunks(body, state: PixelState, steps) -> PixelState:
    """state = body(state, *step) for each step of `steps`, in order: the
    counterpart of lax.scan(jax.checkpoint(body), ...). Under autograd each
    step runs under torch.utils.checkpoint, so only the state between steps
    is kept for the backward pass and a step's (S, P) temporaries are
    recomputed there."""
    grad = torch.is_grad_enabled()
    for step in steps:
        if grad:
            state = checkpoint(body, state, *step, use_reentrant=False)
        else:
            state = body(state, *step)
    return state
