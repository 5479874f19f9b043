"""Densification: clone / split / prune at a fixed capacity (port of
tpu2dgs/model/densify.py).

Every densification interval, splats whose mean screen-space gradient is
at least the threshold are cloned (if small) or split into two (if larger
than percent_dense * scene extent); splats with opacity below the cull
threshold (and, once opacity resets have started, a screen radius above
20 px or a world size above 0.1 * extent) are pruned. Capacity is fixed,
as in the JAX package, and everything is masked row writes:

  * children (one clone copy or two split samples per selected source)
    are compacted into free (dead) slots: the k-th valid child goes to the
    k-th free slot,
  * children beyond the free capacity are dropped and counted, so the
    trainer can grow the capacity,
  * Adam moments of changed rows are zeroed (optim.surgery).

Nothing here reads a value back to the host: `DensifyInfo` holds tensors.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from tpu2dgs_torch.core.transforms import inverse_sigmoid, quat_to_rotmat
from tpu2dgs_torch.model import optim as optim_lib
from tpu2dgs_torch.model.splats import SplatModel, SplatParams


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    """Defaults of record (the reference's)."""

    grad_threshold: float = 2e-4
    percent_dense: float = 0.01
    opacity_cull: float = 0.05
    size_screen: float = 20.0   # max_radii2d prune threshold (px)
    size_world: float = 0.1     # * extent
    split_n: int = 2
    split_shrink: float = 0.8   # new scale = old / (split_shrink * split_n)


class DensifyInfo(NamedTuple):
    num_cloned: torch.Tensor
    num_split: torch.Tensor
    num_pruned: torch.Tensor
    num_dropped: torch.Tensor  # children lost to capacity overflow
    num_live: torch.Tensor


@torch.no_grad()
def add_stats(model: SplatModel, mean2d_grad: torch.Tensor, radii: torch.Tensor) -> SplatModel:
    """Accumulate, in place, the screen-space gradient norms of visible
    splats and the largest screen radius seen."""
    visible = radii > 0
    g = torch.linalg.norm(mean2d_grad, dim=-1)
    model.grad_accum += torch.where(visible, g, 0.0)
    model.denom += visible.to(model.denom.dtype)
    model.max_radii2d.copy_(torch.where(
        visible, torch.maximum(model.max_radii2d, radii.to(torch.float32)),
        model.max_radii2d))
    return model


@torch.no_grad()
def densify_and_prune(
    cfg: DensifyConfig,
    model: SplatModel,
    adam: optim_lib.AdamState,
    generator: Optional[torch.Generator],
    extent: float,
    use_size_prune: bool,  # True once opacity resets have started
    segments: int = 1,
    eps: Optional[torch.Tensor] = None,
):
    """One densification round. Returns (model, adam, DensifyInfo): a new
    model; the Adam moments are changed in place.

    The split noise `eps` (split_n, C, 2), standard normal, is drawn from
    `generator` unless it is handed in (so that a test can give two
    implementations the same numbers)."""
    if segments != 1:
        raise NotImplementedError("segmented densification comes with the multi-device slice")
    p = SplatParams(*(a.detach() for a in model.params))
    c = model.capacity
    live = model.live
    dev = live.device

    grads = torch.where(model.denom > 0,
                        model.grad_accum / torch.clamp(model.denom, min=1.0), 0.0)
    scale_act = torch.exp(p.scaling)                 # (C,2)
    max_scale = torch.amax(scale_act, dim=1)         # (C,)
    opacity_act = torch.sigmoid(p.opacity[:, 0])

    hot = live & (grads >= cfg.grad_threshold)
    small = max_scale <= cfg.percent_dense * extent
    clone_mask = hot & small
    split_mask = hot & ~small

    prune_mask = live & (opacity_act < cfg.opacity_cull)
    if use_size_prune:
        prune_mask = prune_mask | (live & (
            (model.max_radii2d > cfg.size_screen)
            | (max_scale > cfg.size_world * extent)))

    # Split originals are consumed.
    live_after = live & ~prune_mask & ~split_mask

    # --- children -----------------------------------------------------------
    # child j in {0, 1}: j=0 exists for clones and splits, j=1 only for splits.
    rot = quat_to_rotmat(p.rotation)  # (C,3,3)
    if eps is None:
        eps = torch.randn((cfg.split_n, c, 2), dtype=p.xyz.dtype, device=dev,
                          generator=generator)
    # local in-plane displacement (the normal axis has zero std), world = R @ local
    delta_local = eps.to(dev) * scale_act[None, :, :]                 # (J,C,2)
    delta_world = (rot[None, :, :, 0] * delta_local[:, :, 0:1]
                   + rot[None, :, :, 1] * delta_local[:, :, 1:2])     # (J,C,3)
    split_scaling = torch.log(scale_act / (cfg.split_shrink * cfg.split_n))

    def child_params(j):
        return p._replace(
            xyz=torch.where(split_mask[:, None], p.xyz + delta_world[j], p.xyz),
            scaling=torch.where(split_mask[:, None], split_scaling, p.scaling))

    children = SplatParams(*(torch.cat([a, b]) for a, b in
                             zip(child_params(0), child_params(1))))  # (2C, ...)
    child_valid = torch.cat([clone_mask | split_mask, split_mask])    # (2C,)

    # --- compaction: k-th valid child -> k-th free slot ---------------------
    free = ~live_after
    num_free = torch.sum(free)
    slot_order = torch.argsort((~free).to(torch.int8), stable=True)   # free first
    rank = torch.cumsum(child_valid, dim=0) - 1
    write = child_valid & (rank < num_free)
    dest = torch.where(write, slot_order[torch.clamp(rank, 0, c - 1)], c)  # c = dropped

    def scatter(dst, src):
        # One spare row at index c takes every dropped child.
        return torch.cat([dst, dst[:1]]).index_copy_(0, dest, src)[:c]

    ones = torch.ones((2 * c,), dtype=torch.bool, device=dev)
    new_params = SplatParams(*(scatter(a, b) for a, b in zip(p, children)))
    new_live = scatter(live_after, ones)

    # --- optimizer surgery: zero the moments of every changed row -----------
    written = scatter(torch.zeros((c,), dtype=torch.bool, device=dev), ones)
    new_adam = optim_lib.surgery(adam, written | (live & ~live_after))

    info = DensifyInfo(
        num_cloned=torch.sum(clone_mask),
        num_split=torch.sum(split_mask),
        num_pruned=torch.sum(prune_mask),
        num_dropped=torch.sum(child_valid & ~write),
        num_live=torch.sum(new_live),
    )
    return SplatModel(new_params, new_live), new_adam, info


@torch.no_grad()
def reset_opacity(model: SplatModel, adam: optim_lib.AdamState, ceiling: float = 0.01):
    """opacity <- inverse_sigmoid(min(sigmoid(opacity), ceiling)) on live
    rows, in place; the opacity Adam moments are zeroed."""
    new_op = inverse_sigmoid(torch.clamp(torch.sigmoid(model.opacity), max=ceiling))
    model.opacity.copy_(torch.where(model.live[:, None], new_op, model.opacity))
    adam.mu.opacity.zero_()
    adam.nu.opacity.zero_()
    return model, adam
