"""Time the loss stack forward and backward at the bench shape (port of
scripts/loss_probe.py).

    python3 -m tpu2dgs_torch.eval.loss_probe

Four chains on 800x800 maps (train/losses.py, plain PyTorch: no kernel of
the port's own): the photometric loss (0.8 L1 + 0.2 (1 - SSIM)) forward,
the same forward and backward, SSIM alone forward and backward, and the
normal and distortion losses forward and backward (the gradient with
respect to the rendered normal). Each chain is timed by `cuda_ms`
(host-visible: CUDA events around 20 calls) and `device_ms` (the card's
time: one call queued behind a spin). The inputs come from a seeded
torch.Generator: JAX's random streams cannot be reproduced, and no value
here is compared with JAX. Prints a line a chain and one JSON line
(`loss_probe`). On the CPU the chains run once and nothing is timed.
"""

from __future__ import annotations

import json

import torch

from tpu2dgs_torch import default_device
from tpu2dgs_torch.eval.timing import cuda_ms, device_label, device_ms
from tpu2dgs_torch.train import losses

W = H = 800


def grad_sum(loss_of, x):
    """Sum of d loss_of(x) / dx: a backward the caller waits for."""
    x = x.detach().requires_grad_(True)
    return torch.sum(torch.autograd.grad(loss_of(x), x)[0])


def chains(dev, w: int = W, h: int = H) -> dict:
    """The four chains, each a function of no argument returning a scalar
    tensor, on inputs from a generator seeded with 0."""
    gen = torch.Generator(device=dev).manual_seed(0)
    img = torch.rand((3, h, w), generator=gen, device=dev)
    gt = torch.rand((3, h, w), generator=gen, device=dev)
    nrm = torch.randn((3, h, w), generator=gen, device=dev)
    srf = torch.randn((3, h, w), generator=gen, device=dev)
    dist = torch.rand((1, h, w), generator=gen, device=dev)
    return {
        "photometric fwd": lambda: losses.photometric_loss(img, gt, 0.2)[0],
        "photometric fwd+bwd": lambda: grad_sum(
            lambda x: losses.photometric_loss(x, gt, 0.2)[0], img),
        "ssim only fwd+bwd": lambda: grad_sum(lambda x: losses.ssim(x, gt), img),
        "normal+dist fwd+bwd": lambda: grad_sum(
            lambda x: losses.normal_consistency_loss(x, srf) + losses.distortion_loss(dist),
            nrm),
    }


def run(device=None, w: int = W, h: int = H) -> dict:
    dev = default_device(device)
    out = {}
    for name, fn in chains(dev, w, h).items():
        value = float(fn())
        if dev.type == "cuda":
            # One call behind the spin: a chain is up to about 600 launches,
            # and 20 calls' did not fit the launch queue behind the spin
            # (the host then waits for it, and nothing is measured).
            ms = {"cuda_ms": cuda_ms(fn), "device_ms": device_ms(fn, reps=1)}
        else:
            ms = {"cuda_ms": None, "device_ms": None}
        out[name] = {"value": value, **ms}
        print(f"{name:<22s} {ms['cuda_ms']} ms (device {ms['device_ms']})", flush=True)
    return {"w": w, "h": h, "chains": out, "device": device_label(dev)}


def main(argv=None, device=None) -> dict:
    del argv  # no flags
    res = run(device)
    print(json.dumps({"loss_probe": res}), flush=True)
    return res


if __name__ == "__main__":
    main()
