"""Synthetic bench scenes (port of tpu2dgs/eval/synthetic.py).

The same numpy generation from the same seed as the JAX package, so both
packages rasterize exactly the same workload; the results move to
`device` (default CUDA) as float32 tensors. `make_shell_training_set`
turns the shell scene into a training problem: orbit cameras whose ground
truth the port's own forward path renders, and a perturbed copy of the
scene to start from.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu2dgs_torch import default_device
from tpu2dgs_torch.core import cameras, transforms
from tpu2dgs_torch.model import splats as splats_lib
from tpu2dgs_torch.raster import api


def _tensors(arrays, dev):
    return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in arrays)


def make_shell_scene(w: int = 800, h: int = 800, n: int = 1 << 17,
                     seed: int = 0, device=None):
    """Trained-scene-like workload: a textured opaque surfel SHELL.

    Positions on a bumpy sphere, disks tangent to it, near-solid
    opacities, NN-density-matched scales: the regime training produces,
    where transmittance saturates within a few splats per ray. Returns
    (cam_arrays, (xyz, scaling, rotation, opacity, features)) with
    activated scaling and opacity."""
    dev = default_device(device)
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, np.pi, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    rr = shell_radius(theta, phi)
    nrm = np.stack([np.sin(theta) * np.cos(phi),
                    np.cos(theta),
                    np.sin(theta) * np.sin(phi)], -1)
    xyz = (rr[:, None] * nrm).astype(np.float32)
    # Disk tangent to the sphere: quaternion rotating +z onto the radial
    # direction (half-angle form; degenerate antipodal rows get the 180
    # flip about x).
    z = np.array([0.0, 0.0, 1.0])
    c = nrm @ z  # cos(angle)
    ax = np.cross(np.broadcast_to(z, nrm.shape), nrm)
    s = np.linalg.norm(ax, axis=-1)
    half = np.sqrt(np.maximum(0.5 * (1.0 + c), 0.0))  # cos(angle/2)
    sin_half = np.sqrt(np.maximum(0.5 * (1.0 - c), 0.0))
    axn = ax / np.maximum(s, 1e-12)[:, None]
    quat = np.concatenate([half[:, None], axn * sin_half[:, None]], -1)
    quat[c < -1.0 + 1e-9] = [0.0, 1.0, 0.0, 0.0]
    # Scales matched to the surface density (area ~ 4*pi*r^2 over n disks)
    # with the log-spread densification produces.
    mean_r = np.sqrt(4 * np.pi * 0.8 ** 2 / n / np.pi)
    scaling = np.exp(
        np.log(mean_r) + rng.uniform(-0.7, 0.9, (n, 2))).astype(np.float32)
    opacity = rng.uniform(0.75, 0.99, n).astype(np.float32)
    feats = (rng.normal(size=(n, 16, 3)) * 0.25).astype(np.float32)
    feats[:, 0] = (0.5 + 0.45 * np.stack(
        [np.sin(3 * theta), np.cos(2 * phi), np.sin(theta + phi)],
        -1)) / 0.28209479177387814 - 1.0 / 0.28209479177387814 * 0.5

    cam = shell_camera(2 * np.pi * 0.13, w, h).arrays(dev)
    return cam, _tensors((xyz, scaling, quat, opacity, feats), dev)


def shell_radius(theta, phi):
    """The shell's radius along polar angle theta (from +y) and azimuth phi
    (from +x towards +z): r = 0.8 + 0.1 sin(4 theta) cos(3 phi)."""
    return 0.8 + 0.1 * np.sin(4 * theta) * np.cos(3 * phi)


def shell_surface_points(n: int, seed: int = 0) -> np.ndarray:
    """(n, 3) float64 points of the shell surface whose directions are
    uniform on the sphere: the generating surface that a mesh of the shell
    scene is held against."""
    d = np.random.default_rng(seed).normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    theta = np.arccos(np.clip(d[:, 1], -1.0, 1.0))
    phi = np.arctan2(d[:, 2], d[:, 0])
    return shell_radius(theta, phi)[:, None] * d


def shell_camera(angle: float, w: int, h: int) -> cameras.Camera:
    """The shell scene's camera at orbit angle `angle` (radians): 2.2 units
    from the origin, looking at it (make_shell_scene uses 2*pi*0.13)."""
    fwd = np.array([-np.sin(angle), 0.12 * np.sin(3 * angle), -np.cos(angle)])
    fwd /= np.linalg.norm(fwd)
    pos = -2.2 * fwd
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    tu = np.cross(fwd, right)
    Rw2v = np.stack([right, tu, fwd])
    return cameras.Camera(
        uid=0, image_name="shell", R=Rw2v.T, T=-Rw2v @ pos,
        fovx=np.pi / 3, fovy=np.pi / 3, width=w, height=h,
    )


def make_bench_scene(w: int = 800, h: int = 800, n: int = 1 << 17,
                     seed: int = 0, device=None):
    """The headline bench workload: a worst-case depth pileup of `n`
    random anisotropic surfels filling a 90-degree frustum.

    Returns (cam_arrays, (xyz, scaling, rotation, opacity, features))."""
    dev = default_device(device)
    cam = cameras.Camera(
        uid=0, image_name="bench", R=np.eye(3), T=np.zeros(3),
        fovx=np.pi / 2, fovy=np.pi / 2, width=w, height=h,
    ).arrays(dev)
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.0, 1.0, (n, 3)) * [1, 1, 0.5] + [0, 0, 2.5]
    scene = _tensors((
        xyz,
        np.exp(rng.uniform(-5.0, -3.5, (n, 2))),
        rng.normal(size=(n, 4)),
        rng.uniform(0.2, 0.95, (n,)),
        rng.normal(size=(n, 16, 3)) * 0.3,
    ), dev)
    return cam, scene


def scene_model(scene) -> splats_lib.SplatModel:
    """A scene's activated (xyz, scaling, rotation, opacity, features) as a
    parameter store (log scales, logit opacities, SH split into dc/rest),
    every row live: what save_ply writes and load_ply serves."""
    xyz, scaling, rotation, opacity, feats = scene
    params = splats_lib.SplatParams(
        xyz=xyz, features_dc=feats[:, :1].contiguous(),
        features_rest=feats[:, 1:].contiguous(), scaling=torch.log(scaling),
        rotation=rotation, opacity=transforms.inverse_sigmoid(opacity)[:, None])
    live = torch.ones(xyz.shape[0], dtype=torch.bool, device=xyz.device)
    return splats_lib.SplatModel(params, live)


def make_shell_training_set(w: int = 800, h: int = 800, n: int = 1 << 17, views: int = 4,
                            seed: int = 0, device=None, **raster_kwargs):
    """A training problem on the shell scene. Returns (cameras, model):

      * `views` orbit cameras, evenly spaced from the scene's own pose,
        each with its ground-truth image (3,H,W) rendered from the exact
        scene by raster.api.render under no_grad with `raster_kwargs`;
      * the scene perturbed from `seed` as a parameter store: positions
        jittered by a fifth of the mean disk radius, log-scales by 0.2,
        logit opacities lowered by 1 and jittered, colours (SH band 0) by
        0.4, the higher SH bands zeroed."""
    dev = default_device(device)
    _, scene = make_shell_scene(w, h, n, seed=seed, device=dev)
    cams = [shell_camera(2 * np.pi * (0.13 + k / views), w, h) for k in range(views)]
    settings = api.RasterSettings(w, h, **raster_kwargs)
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        for k, cam in enumerate(cams):
            cam.uid, cam.image_name = k, f"shell{k}"
            out = api.render(cam.arrays(dev), settings, *scene, bg, device=dev)
            cam.image = out["render"].cpu().numpy()

    gen = torch.Generator().manual_seed(seed + 1)

    def noise(like, std):
        return (torch.randn(like.shape, generator=gen) * std).to(dev)

    model = scene_model(scene)
    mean_r = float(np.sqrt(4 * 0.8 ** 2 / n))
    with torch.no_grad():
        model.xyz += noise(model.xyz, 0.2 * mean_r)
        model.scaling += noise(model.scaling, 0.2)
        model.opacity += noise(model.opacity, 0.3) - 1.0
        model.features_dc += noise(model.features_dc, 0.4)
        model.features_rest.zero_()
    return cams, model
