"""Splat parameter store (port of tpu2dgs/model/splats.py).

Parameters are padded to a fixed capacity with a `live` mask, as in the
JAX package, so checkpoints and capacities carry across. Parameter
semantics match the reference, and PLY files are bit-compatible:
  xyz (C,3) world positions
  features_dc (C,1,3), features_rest (C,K-1,3) SH coefficients
  scaling (C,2) log tangential scales          (activation: exp)
  rotation (C,4) raw wxyz quaternion           (activation: normalize)
  opacity (C,1) logit                          (activation: sigmoid)

`SplatModel` is an nn.Module: the six parameters, the `live` buffer and
the densification statistics (`max_radii2d`, `grad_accum`, `denom`) as
buffers.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from tpu2dgs_torch import default_device
from tpu2dgs_torch.core import sh as sh_lib
from tpu2dgs_torch.core.transforms import inverse_sigmoid
from tpu2dgs_torch.model.knn import mean_dist2_to_3nn

INIT_OPACITY = 0.1  # the reference's initial opacity


class SplatParams(NamedTuple):
    """The trainable leaves (every tensor padded to capacity C)."""

    xyz: torch.Tensor            # (C,3)
    features_dc: torch.Tensor    # (C,1,3)
    features_rest: torch.Tensor  # (C,K-1,3)
    scaling: torch.Tensor        # (C,2) log
    rotation: torch.Tensor       # (C,4) wxyz raw
    opacity: torch.Tensor        # (C,1) logit


STATS = ("max_radii2d", "grad_accum", "denom")


class SplatModel(nn.Module):
    """Parameters (one nn.Parameter per SplatParams field), the live mask
    and the densification statistics, each (C,) float32: the largest
    screen radius seen, the summed norm of the screen-space gradient, and
    the number of steps the splat was visible. Statistics not given start
    at zero."""

    def __init__(self, params: SplatParams, live: torch.Tensor, max_radii2d=None,
                 grad_accum=None, denom=None):
        super().__init__()
        for name, value in params._asdict().items():
            setattr(self, name, nn.Parameter(value.detach()))
        self.register_buffer("live", live)
        for name, value in zip(STATS, (max_radii2d, grad_accum, denom)):
            if value is None:
                value = torch.zeros(live.shape, dtype=torch.float32, device=live.device)
            self.register_buffer(name, value)

    @property
    def params(self) -> SplatParams:
        return SplatParams(*(getattr(self, name) for name in SplatParams._fields))

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def num_live(self) -> torch.Tensor:
        return torch.sum(self.live)


def features(params: SplatParams) -> torch.Tensor:
    """(C,K,3) full SH coefficient stack."""
    return torch.cat([params.features_dc, params.features_rest], dim=1)


def round_capacity(n: int, multiple: int = 4096) -> int:
    """Capacity granularity of the padded store (as the JAX package)."""
    return max(multiple, int(math.ceil(n / multiple)) * multiple)


def empty_model(capacity: int, sh_degree: int = 3, device=None) -> SplatModel:
    dev = default_device(device)
    k = sh_lib.num_sh_coeffs(sh_degree)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    rotation = z(capacity, 4)
    rotation[:, 0] = 1.0
    params = SplatParams(
        xyz=z(capacity, 3),
        features_dc=z(capacity, 1, 3),
        features_rest=z(capacity, k - 1, 3),
        scaling=z(capacity, 2),
        rotation=rotation,
        opacity=z(capacity, 1),
    )
    return SplatModel(params, torch.zeros((capacity,), dtype=torch.bool, device=dev))


# Above this many points the init scales come from the Morton KNN on the
# host (approximate), below it from the exact sweep on the device: the JAX
# package's choice at the JAX package's size, so both start alike.
MORTON_KNN_ABOVE = 65536


def _knn_dist2(points: np.ndarray, pts: torch.Tensor) -> torch.Tensor:
    if pts.shape[0] > MORTON_KNN_ABOVE:
        from tpu2dgs_torch.native import knn as native_knn

        return torch.from_numpy(native_knn.knn_mean_dist2(points)).to(pts.device)
    return mean_dist2_to_3nn(pts)


@torch.no_grad()
def create_from_pcd(points: np.ndarray, colors: np.ndarray, sh_degree: int = 3,
                    capacity: int | None = None, device=None) -> SplatModel:
    """A model from a point cloud, as the reference's create_from_pcd:
    isotropic log-scale from the mean distance to the 3 nearest
    neighbours, identity rotations, opacity 0.1, DC colour from RGB.
    points (N,3), colors (N,3) RGB in [0,1]."""
    n = points.shape[0]
    model = empty_model(capacity or round_capacity(n), sh_degree, device=device)
    dev = model.xyz.device
    pts = torch.from_numpy(np.asarray(points, np.float32)).to(dev)
    rgb = torch.from_numpy(np.asarray(colors, np.float32)).to(dev)
    dist2 = torch.clamp(_knn_dist2(np.asarray(points, np.float32), pts), min=1e-7)
    model.xyz[:n] = pts
    model.features_dc[:n, 0, :] = sh_lib.rgb_to_sh(rgb)
    model.scaling[:n] = torch.log(torch.sqrt(dist2))[:, None]
    model.opacity[:n] = float(inverse_sigmoid(torch.tensor(INIT_OPACITY)))
    model.live[:n] = True
    return model


def pad_segments(a: torch.Tensor, new_rows: int, segments: int = 1) -> torch.Tensor:
    """`a` (C, ...) as `segments` contiguous blocks, each padded with zero
    rows at its end to new_rows / segments rows."""
    c = a.shape[0]
    s = segments
    if c % s or new_rows % s:
        raise ValueError(f"capacities {c} and {new_rows} are not {s} equal segments")
    seg = a.reshape(s, c // s, *a.shape[1:])
    pad = seg.new_zeros((s, (new_rows - c) // s, *a.shape[1:]))
    return torch.cat([seg, pad], dim=1).reshape(new_rows, *a.shape[1:])


@torch.no_grad()
def grow_capacity(model: SplatModel, new_capacity: int, segments: int = 1) -> SplatModel:
    """A new model with every per-splat tensor padded to `new_capacity`:
    dead rows with identity rotations. With `segments` = S (splat
    sharding: the capacity axis is S contiguous blocks, and densification
    fills free slots of a child's own block, model/densify.py) each old
    block keeps its rows and gains (new - old) / S free rows at its end:
    an end pad would leave every full block full."""
    c = model.capacity
    if new_capacity < c:
        raise ValueError(f"cannot shrink capacity {c} to {new_capacity}")
    if new_capacity == c:
        return model

    def pad(a):
        return pad_segments(a.detach(), new_capacity, segments)

    params = SplatParams(*(pad(a) for a in model.params))
    old = pad(torch.ones((c,), dtype=torch.bool, device=model.live.device))
    params.rotation[~old, 0] = 1.0
    return SplatModel(params, pad(model.live), *(pad(getattr(model, k)) for k in STATS))


# ---------------------------------------------------------------------------
# PLY interchange (the reference attribute layout; self-contained binary
# PLY codec, no plyfile dependency).
# ---------------------------------------------------------------------------


def _ply_attribute_names(num_rest: int) -> list[str]:
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(num_rest * 3)]
    names += ["opacity", "scale_0", "scale_1"]
    names += [f"rot_{i}" for i in range(4)]
    return names


def save_ply(model: SplatModel, path: str) -> None:
    """Write live splats in the reference attribute layout (float32 LE)."""
    live = model.live.detach().cpu().numpy()
    p = SplatParams(*(a.detach().cpu().numpy() for a in model.params))
    xyz = p.xyz[live]
    n = xyz.shape[0]
    num_rest = p.features_rest.shape[1]
    # (N,1,3)->(N,3) and (N,R,3)->(N,3,R)->flat: channel-major, as the
    # reference's transpose(1,2).flatten.
    f_dc = p.features_dc[live].transpose(0, 2, 1).reshape(n, -1)
    f_rest = p.features_rest[live].transpose(0, 2, 1).reshape(n, -1)
    cols = np.concatenate(
        [
            xyz,
            np.zeros((n, 3), np.float32),  # nx, ny, nz
            f_dc,
            f_rest,
            p.opacity[live],
            p.scaling[live],
            p.rotation[live],
        ],
        axis=1,
    ).astype("<f4")

    names = _ply_attribute_names(num_rest)
    assert cols.shape[1] == len(names)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(cols.tobytes())


def _parse_ply_header(f):
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    count = 0
    props: list[tuple[str, str]] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tok = line.decode("ascii", "replace").strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element" and tok[1] == "vertex":
            count = int(tok[2])
        elif tok[0] == "property" and len(tok) == 3:
            props.append((tok[2], tok[1]))
        elif tok[0] == "end_header":
            break
    return fmt, count, props


_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "uint": "<u4",
}


def read_ply_vertices(path: str) -> dict[str, np.ndarray]:
    """Read a binary/ascii PLY vertex element into {name: (N,) array}."""
    with open(path, "rb") as f:
        fmt, count, props = _parse_ply_header(f)
        if fmt == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=count)
            data = data.reshape(count, len(props))
            return {name: data[:, i].astype(np.float32)
                    for i, (name, _) in enumerate(props)}
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported PLY format {fmt!r}")
        dtype = np.dtype([(name, _PLY_DTYPES[t]) for name, t in props])
        raw = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype)
        return {name: np.ascontiguousarray(raw[name]) for name, _ in props}


def load_ply(path: str, sh_degree: int = 3, capacity: int | None = None,
             device=None) -> SplatModel:
    """Load a reference-format splat PLY into a model on `device`
    (default CUDA). Callers render it at its full SH degree."""
    dev = default_device(device)
    v = read_ply_vertices(path)
    n = v["x"].shape[0]
    num_rest = sh_lib.num_sh_coeffs(sh_degree) - 1

    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1)
    f_dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], axis=1)[:, None, :]
    rest_names = sorted(
        (name for name in v if name.startswith("f_rest_")),
        key=lambda s: int(s.split("_")[-1]),
    )
    if len(rest_names) != num_rest * 3:
        raise ValueError(f"{len(rest_names)} f_rest properties; SH degree "
                         f"{sh_degree} needs {num_rest * 3}")
    # stored channel-major (3, R) per splat -> (N,R,3)
    f_rest = np.stack([v[name] for name in rest_names], axis=1)
    f_rest = f_rest.reshape(n, 3, num_rest).transpose(0, 2, 1)
    opacity = v["opacity"][:, None]
    scaling = np.stack([v["scale_0"], v["scale_1"]], axis=1)
    rotation = np.stack([v[f"rot_{i}"] for i in range(4)], axis=1)

    cap = capacity or round_capacity(n)
    model = empty_model(cap, sh_degree, device=dev)
    with torch.no_grad():
        for name, arr in (("xyz", xyz), ("features_dc", f_dc), ("features_rest", f_rest),
                          ("scaling", scaling), ("rotation", rotation), ("opacity", opacity)):
            getattr(model, name)[:n] = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(dev)
        model.live[:n] = True
    return model
