"""Adam and learning-rate schedules for splat training (port of
tpu2dgs/model/optim.py).

torch.optim.Adam(eps=1e-15) semantics with one learning rate per
parameter, written out as functions on tensors rather than taken from
torch.optim: the JAX package's Adam freezes dead rows through the live
mask, shares ONE step count between all parameters, and lets
densification zero the moments of changed rows (`surgery`), and the port
keeps those semantics so the two train alike. Everything runs under
torch.no_grad() and writes parameters and moments in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from tpu2dgs_torch.model.splats import SplatParams


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Learning rates of record (the reference's defaults)."""

    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 2.5e-3
    opacity_lr: float = 0.05
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-15


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000) -> float:
    """Log-linear interpolation with optional delay ramp, in float32 on
    the host (the JAX package computes it in float32 on the device)."""
    f32 = torch.float32
    step = torch.as_tensor(step, dtype=f32)
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_lerp = torch.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
    else:
        delay_rate = 1.0
    return float(delay_rate * log_lerp)


class AdamState(NamedTuple):
    count: int  # steps taken, shared by every parameter
    mu: SplatParams
    nu: SplatParams


def init_adam(params: SplatParams) -> AdamState:
    def zeros():
        return SplatParams(*(torch.zeros_like(p, requires_grad=False) for p in params))

    return AdamState(count=0, mu=zeros(), nu=zeros())


def learning_rates(cfg: OptimConfig, step, spatial_lr_scale) -> SplatParams:
    """Per-parameter learning rates at `step` (xyz follows the exponential
    schedule scaled by the scene extent)."""
    xyz_lr = expon_lr(
        step,
        cfg.position_lr_init * spatial_lr_scale,
        cfg.position_lr_final * spatial_lr_scale,
        lr_delay_mult=cfg.position_lr_delay_mult,
        max_steps=cfg.position_lr_max_steps,
    )
    return SplatParams(
        xyz=xyz_lr,
        features_dc=cfg.feature_lr,
        features_rest=cfg.feature_lr / 20.0,
        scaling=cfg.scaling_lr,
        rotation=cfg.rotation_lr,
        opacity=cfg.opacity_lr,
    )


@torch.no_grad()
def adam_step(
    cfg: OptimConfig,
    params: SplatParams,
    grads: SplatParams,
    state: AdamState,
    lrs: SplatParams,
    live: torch.Tensor,  # (C,) bool: dead slots are frozen
):
    """One Adam step, in place on `params` and the moments of `state`.
    Returns (params, AdamState with the new count)."""
    count = state.count + 1
    b1, b2 = cfg.beta1, cfg.beta2
    # bias corrections in float32, as the JAX package rounds them
    c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** count)
    c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** count)

    for p, g, m, v, lr in zip(params, grads, state.mu, state.nu, lrs):
        mask = live.reshape((-1,) + (1,) * (p.dim() - 1))
        g = torch.where(mask, g, 0.0)
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        step = lr * (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        p.copy_(torch.where(mask, p - step, p))
    return params, AdamState(count=count, mu=state.mu, nu=state.nu)


@torch.no_grad()
def surgery(state: AdamState, reset_rows: torch.Tensor) -> AdamState:
    """Zero the Adam moments at `reset_rows` (bool (C,)), in place."""
    for a in (*state.mu, *state.nu):
        a.masked_fill_(reset_rows.reshape((-1,) + (1,) * (a.dim() - 1)), 0.0)
    return state
