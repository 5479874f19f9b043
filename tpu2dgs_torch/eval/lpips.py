"""The LPIPS perceptual metric in PyTorch (VGG16 backbone and linear
heads; port of tpu2dgs/eval/lpips.py).

VGG16's relu1_2..relu5_3 features of both images, each unit-normalised
over its channels, squared differences weighed by the learned 1x1 linear
heads, averaged over the pixels and summed over the five layers
(reference lpipsPyTorch/). The 13 convolutions are `F.conv2d` in float32
(TF32 off, `tpu2dgs_torch/__init__.py`), as the JAX package computes them
with `lax.conv_general_dilated`: no kernel of the repo's own.

The weights are not in the repository. The port reads the npz that the
JAX package's converter writes (`tpu2dgs.eval.lpips.convert_torch_weights`,
`scripts/fetch_lpips_weights.py`; both need torchvision and the network):
the path in TPU2DGS_LPIPS_WEIGHTS, else
`tpu2dgs_torch/eval/weights/lpips_vgg.npz`. Without it `load_weights`
raises FileNotFoundError, which `cli.metrics` reports as LPIPS being
unavailable.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from tpu2dgs_torch import default_device

# VGG16 conv layout: (out_channels, num_convs) per block
_VGG_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
# The reference's ScalingLayer: inputs in [-1, 1] to ImageNet statistics
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def default_weights_path() -> str:
    return os.environ.get(
        "TPU2DGS_LPIPS_WEIGHTS",
        os.path.join(os.path.dirname(__file__), "weights", "lpips_vgg.npz"),
    )


def load_weights(path: str | None = None) -> dict[str, np.ndarray]:
    path = path or default_weights_path()
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"LPIPS weights not found at {path}. On any machine with network "
            "access and torchvision run:\n"
            "    python scripts/fetch_lpips_weights.py --out lpips_vgg.npz\n"
            "then copy the npz to tpu2dgs_torch/eval/weights/lpips_vgg.npz or set "
            "TPU2DGS_LPIPS_WEIGHTS to it."
        )
    z = np.load(path)
    return {k: z[k] for k in z.files}


def _vgg_features(convs, x: torch.Tensor) -> list[torch.Tensor]:
    """x: (N,3,H,W) in [-1,1]. The five blocks' last ReLU outputs."""
    shift = torch.as_tensor(_SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.as_tensor(_SCALE, device=x.device).view(1, 3, 1, 1)
    h = (x - shift) / scale
    feats, layer = [], iter(convs)
    for b, (_, n_convs) in enumerate(_VGG_BLOCKS):
        for _ in range(n_convs):
            w, bias = next(layer)
            h = F.relu(F.conv2d(h, w, bias, padding=1))
        feats.append(h)
        if b < len(_VGG_BLOCKS) - 1:
            h = F.max_pool2d(h, 2)
    return feats


def _normalize(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return feat / (torch.sqrt(torch.sum(feat * feat, dim=1, keepdim=True)) + eps)


def lpips_fn(weights_path: str | None = None, device=None):
    """lpips(img1, img2) -> 0-d tensor, for (3,H,W) images in [0,1], on
    `device` (default: the GPU). The weights go to the device once, here."""
    dev = default_device(device)
    weights = load_weights(weights_path)

    def on(name):
        return torch.from_numpy(np.ascontiguousarray(weights[name], np.float32)).to(dev)

    n_convs = sum(n for _, n in _VGG_BLOCKS)
    convs = [(on(f"conv{i}_w"), on(f"conv{i}_b")) for i in range(n_convs)]
    lins = [on(f"lin{i}_w").view(1, -1, 1, 1) for i in range(len(_VGG_BLOCKS))]

    @torch.no_grad()
    def compute(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        x = torch.stack([torch.as_tensor(i).to(dev, torch.float32) for i in (a, b)])
        total = torch.zeros((), device=dev)
        for f, lin in zip(_vgg_features(convs, x * 2.0 - 1.0), lins):
            f = _normalize(f)
            total = total + torch.mean(torch.sum((f[0:1] - f[1:2]) ** 2 * lin, dim=1))
        return total

    return compute
