"""Marching tetrahedra iso-surface extraction, vectorized numpy (the port's
own copy of tpu2dgs/mesh/marching.py; it stays on the host, as there).

Replaces the reference's skimage `measure.marching_cubes` dependency
(utils/mcube_utils.py:17-95) with a self-contained implementation: each grid
cell splits into 6 tetrahedra; each tetrahedron emits 0-2 triangles where
the scalar field crosses `level`. Produces watertight surfaces (more
triangles than marching cubes, same geometry) — downstream Chamfer/F1 eval
samples points, so triangle count is immaterial.

All heavy lifting is dense numpy over (cells, 6 tets); no Python per-cell
loops.
"""

from __future__ import annotations

import numpy as np

# Cube corner offsets, index 0..7 (x fastest).
_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
])

# 6-tetrahedra decomposition of the cube around the main diagonal 0-6.
_TETS = np.array([
    [0, 5, 1, 6],
    [0, 1, 2, 6],
    [0, 2, 3, 6],
    [0, 3, 7, 6],
    [0, 7, 4, 6],
    [0, 4, 5, 6],
])

# Tet edges as (corner a, corner b) local indices 0..3.
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]])


def _build_tet_table():
    """For each of 16 inside-bitmasks: up to 2 triangles as triples of
    tet-edge indices (-1 padded). "Inside" = value < level."""
    table = -np.ones((16, 2, 3), np.int64)

    def edge(a, b):
        for i, (x, y) in enumerate(_TET_EDGES):
            if {x, y} == {a, b}:
                return i
        raise AssertionError

    for case in range(16):
        inside = [i for i in range(4) if case >> i & 1]
        outside = [i for i in range(4) if not case >> i & 1]
        if len(inside) == 1:
            a = inside[0]
            b, c, d = outside
            table[case, 0] = [edge(a, b), edge(a, c), edge(a, d)]
        elif len(inside) == 3:
            a = outside[0]
            b, c, d = inside
            # reversed winding vs the 1-inside case
            table[case, 0] = [edge(a, b), edge(a, d), edge(a, c)]
        elif len(inside) == 2:
            a, b = inside
            c, d = outside
            ac, ad, bc, bd = edge(a, c), edge(a, d), edge(b, c), edge(b, d)
            table[case, 0] = [ac, ad, bc]
            table[case, 1] = [bc, ad, bd]
    return table


_TET_TABLE = _build_tet_table()


def marching_tetrahedra(grid: np.ndarray, level: float = 0.0,
                        origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0),
                        mask: np.ndarray | None = None):
    """Extract the iso-surface of `grid` (X,Y,Z scalar field).

    Args:
      grid: (NX, NY, NZ) float field.
      level: iso value.
      origin, spacing: world placement of grid[0,0,0] and voxel size.
      mask: optional (NX, NY, NZ) bool; cells touching an invalid corner are
        skipped (the reference masks unobserved TSDF voxels via weight=0).

    Returns:
      verts (V,3) float64 world coords, faces (F,3) int64. Shared vertices
      are merged (exact duplicates from adjacent cells).
    """
    f = np.ascontiguousarray(np.asarray(grid, np.float32))
    f = f - np.float32(level)
    nx, ny, nz = f.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    # Active cells via slice logic — NEVER materialize the (cells, 8)
    # corner array densely (8.5 GB f64 at 512^3, 68 GB at 1024^3).
    cx, cy, cz = nx - 1, ny - 1, nz - 1
    inside_grid = f < 0.0
    any_in = np.zeros((cx, cy, cz), bool)
    all_in = np.ones((cx, cy, cz), bool)
    ok = np.ones((cx, cy, cz), bool)
    valid = None if mask is None else np.asarray(mask, bool)
    for dx, dy, dz in _CORNERS:
        s = inside_grid[dx:cx + dx, dy:cy + dy, dz:cz + dz]
        any_in |= s
        all_in &= s
        if valid is not None:
            ok &= valid[dx:cx + dx, dy:cy + dy, dz:cz + dz]
    active = ok & any_in & ~all_in
    del any_in, all_in, ok, inside_grid
    idx_all = np.argwhere(active).astype(np.int32)   # (A, 3)
    del active
    if idx_all.shape[0] == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    tet_corner_off = _CORNERS[_TETS].astype(np.float32)  # (6, 4, 3)
    ea = _TET_EDGES[:, 0]
    eb = _TET_EDGES[:, 1]
    pow2 = (1 << np.arange(4)).astype(np.int16)

    # Chunk active cells to bound peak memory (~250 MB per 1M cells).
    chunks = []
    for c0 in range(0, idx_all.shape[0], 1 << 20):
        idx = idx_all[c0:c0 + (1 << 20)]
        a = idx.shape[0]
        vals8 = np.empty((a, 8), np.float32)
        for i, (dx, dy, dz) in enumerate(_CORNERS):
            vals8[:, i] = f[idx[:, 0] + dx, idx[:, 1] + dy, idx[:, 2] + dz]

        tet_vals = vals8[:, _TETS]                   # (A, 6, 4)
        # world-grid corner positions by broadcast (no repeats)
        tet_pos = (idx[:, None, None, :].astype(np.float32)
                   + tet_corner_off[None])           # (A, 6, 4, 3)

        case = ((tet_vals < 0.0) @ pow2).astype(np.int64)   # (A, 6)
        tris = _TET_TABLE[case]                      # (A, 6, 2, 3) edge ids
        tri_mask = tris[..., 0] >= 0                 # (A, 6, 2)

        # Interpolated vertex on every tet edge (A, 6, 6edge, 3).
        va = tet_vals[:, :, ea]                      # (A, 6, 6)
        vb = tet_vals[:, :, eb]
        denom = vb - va
        t = np.where(np.abs(denom) > 1e-12,
                     -va / np.where(denom == 0, 1, denom), 0.5)
        t = np.clip(t, 0.0, 1.0).astype(np.float32)
        pa = tet_pos[:, :, ea, :]                    # (A, 6, 6, 3)
        pb = tet_pos[:, :, eb, :]
        edge_pts = pa + t[..., None] * (pb - pa)     # (A, 6, 6, 3)

        sel = np.where(tris < 0, 0, tris)            # (A, 6, 2, 3)
        ar_a = np.arange(a)[:, None, None, None]
        ar_t = np.arange(6)[None, :, None, None]
        tp = edge_pts[ar_a, ar_t, sel]               # (A, 6, 2, 3, 3)
        chunks.append(tp[tri_mask])                  # (T_c, 3, 3)
    tri_pts = (chunks[0] if len(chunks) == 1
               else np.concatenate(chunks, axis=0))  # (T, 3, 3)

    # Merge duplicate vertices (exact coordinates: interpolation on a shared
    # edge is bit-identical across cells because va/vb come from the same
    # grid entries in the same roles... not guaranteed across tets, so
    # quantize).
    flat = tri_pts.reshape(-1, 3)
    # Merge via ONE packed int64 key (1e-3 cell-unit quantization: three
    # 20-bit fields cover res <= 1048; a row-wise unique over the same
    # data lexsorts 3-column structs ~10x slower). 1e-3 of a cell is far
    # below any real vertex separation and above f32 interpolation noise.
    quant = np.round(flat * np.float32(1e3)).astype(np.int64)  # < 2^20
    if max(nx, ny, nz) <= 1048:
        key = (quant[:, 0] << 40) | (quant[:, 1] << 20) | quant[:, 2]
        uniq, first, inv = np.unique(
            key, return_index=True, return_inverse=True)
    else:
        # Wide grids overflow the 20-bit fields: fall back to a row-wise
        # unique over the raw quantized triples (void view = one memcmp
        # key per row; slower than the packed path but unbounded).
        rec = np.ascontiguousarray(quant).view(
            np.dtype((np.void, quant.dtype.itemsize * 3))).reshape(-1)
        uniq, first, inv = np.unique(
            rec, return_index=True, return_inverse=True)
    verts = flat[first].astype(np.float64)
    faces = inv.reshape(-1, 3)

    # Drop degenerate faces.
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[good]

    verts = verts * np.asarray(spacing)[None, :] + np.asarray(origin)[None, :]
    return verts, faces
