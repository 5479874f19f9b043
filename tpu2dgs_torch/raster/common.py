"""Shared rasterizer constants (port of tpu2dgs/raster/common.py).

Preprocess computes screen bounds with the same CUTOFF the blend uses to
gate contributions, so binning captures exactly the set of splats a pixel
can blend. The CUDA kernels in csrc/ carry the float32 roundings of these
values as literals.
"""

# Frustum near-plane cull for splat centers.
NEAR_CULL = 0.2

# Screen-space low-pass filter: rho2d = FILTER_INV_SQUARE * |d|^2, a fixed
# ~0.7px-sigma anti-aliasing floor.
FILTER_INV_SQUARE = 2.0

# Gaussian evaluated out to CUTOFF sigmas.
CUTOFF = 3.0

# Minimum screen radius so the low-pass footprint is fully rasterized.
MIN_RADIUS = 3.0

ALPHA_MIN = 1.0 / 255.0
ALPHA_CLAMP = 0.99
T_EPS = 1e-4
MEDIAN_T = 0.5
DIST_NEAR = 0.2
DIST_FAR = 100.0
INTERSECT_NEAR = 0.2  # minimum per-pixel intersection depth
