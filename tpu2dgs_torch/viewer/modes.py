"""The viewer's render modes: RGB / alpha / normal / depth / edge /
curvature (port of tpu2dgs/viewer/modes.py; reference
utils/image_utils.py:23-61). Single-channel outputs are turbo-colormapped
for display. Plain PyTorch on the render's device."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _turbo_anchor(x: np.ndarray) -> np.ndarray:
    # polynomial approximation of the Google turbo colormap
    r = 0.13572138 + 4.61539260 * x - 42.66032258 * x**2 + 132.13108234 * x**3 \
        - 152.94239396 * x**4 + 59.28637943 * x**5
    g = 0.09140261 + 2.19418839 * x + 4.84296658 * x**2 - 14.18503333 * x**3 \
        + 4.27729857 * x**4 + 2.82956604 * x**5
    b = 0.10667330 + 12.64194608 * x - 60.58204836 * x**2 + 110.36276771 * x**3 \
        - 89.90310912 * x**4 + 27.34824973 * x**5
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


# The 256-entry turbo table, as the JAX package builds it.
_TURBO = _turbo_anchor(np.linspace(0.0, 1.0, 256)).astype(np.float32)
# Sobel x-derivative over 4; its transpose is the y-derivative.
_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32) / 4.0


def colormap(map_1hw: torch.Tensor) -> torch.Tensor:
    """(1,H,W) -> (3,H,W) turbo-mapped, min-max normalised (indices
    rounded half to even, as jnp.round)."""
    m = map_1hw[0]
    lo, hi = torch.min(m), torch.max(m)
    t = (m - lo) / torch.clamp(hi - lo, min=1e-12)
    idx = torch.clamp(torch.round(t * 255.0).to(torch.int64), 0, 255)
    return torch.as_tensor(_TURBO, device=m.device)[idx].permute(2, 0, 1)


def gradient_map(image_chw: torch.Tensor) -> torch.Tensor:
    """Sobel edge magnitude (1,H,W) of a (C,H,W) image (zero padding)."""
    sx = torch.as_tensor(_SOBEL_X, device=image_chw.device)
    kernels = torch.stack([sx, sx.T])[:, None]               # (2,1,3,3): x, y
    g = F.conv2d(image_chw[:, None], kernels, padding=1)     # (C,2,H,W)
    mag = torch.sqrt(g[:, 0] ** 2 + g[:, 1] ** 2)            # (C,H,W)
    return torch.sqrt(torch.sum(mag * mag, dim=0, keepdim=True))


def render_net_image(render_pkg: dict, render_items: list[str],
                     render_mode: int) -> torch.Tensor:
    """(3,H,W) display image for the selected viewer mode."""
    output = render_items[render_mode].lower()
    if output == "alpha":
        net_image = render_pkg["rend_alpha"]
    elif output == "normal":
        net_image = (render_pkg["rend_normal"] + 1.0) / 2.0
    elif output == "depth":
        net_image = render_pkg["surf_depth"]
    elif output == "edge":
        net_image = gradient_map(render_pkg["render"])
    elif output == "curvature":
        net_image = gradient_map((render_pkg["rend_normal"] + 1.0) / 2.0)
    else:
        net_image = render_pkg["render"]
    if net_image.shape[0] == 1:
        net_image = colormap(net_image)
    return net_image
