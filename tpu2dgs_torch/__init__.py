"""tpu2dgs_torch — 2D Gaussian (surfel) Splatting in PyTorch with CUDA
kernels written by hand for NVIDIA Hopper (sm_90a).

The port of the JAX/Pallas package `tpu2dgs`, which stays the reference it
is tested against. The module layout mirrors `tpu2dgs` so each module's
counterpart is found under the same path:

  core/      camera models, spherical harmonics, quaternion/surfel transforms
  raster/    preprocess, depth compaction, the select kernel (binning) and
             the CUDA blend backend (forward and backward), the render() API
  model/     padded splat parameter store, PLY codec, KNN scale init, Adam,
             densification, conversion of weights and training state
  train/     losses, the training step and the Trainer, checkpoints, logging
  data/      COLMAP and Blender scene loading, camera trajectories
  mesh/      TSDF fusion (bounded and contracted) on the device, marching
             tetrahedra on the host, visibility culling, mesh PLYs
  cli/       train, render (and mesh), metrics and convert from the
             command line
  eval/      synthetic bench scenes and a training set, the serve and
             train profiles, the binning and reduction probes, the
             geometry evaluators (Chamfer, F-score, TnT and DTU scenes),
             and the JAX repo's scripts: the training bench and soak, the
             fidelity, capacity, loss and strip-balance probes, the
             dataset harnesses and their summary
  native/    nvcc build of csrc/*.cu (and g++ build of the host's Morton KNN)
             into shared libraries bound with ctypes
  csrc/      the CUDA C++ kernels

This package imports neither jax nor tpu2dgs. Its entry points run on the
GPU unless the caller passes device="cpu"; on the CPU every kernel wrapper
runs its plain PyTorch version.
"""

import torch

__version__ = "0.1.0"

# Full-f32 products, as tpu2dgs/__init__.py pins for JAX: TF32 keeps ~3
# decimal digits, enough to move the splat homographies visibly.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else CUDA.

    Raises when CUDA is asked for, explicitly or by default, and there is
    none: the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpu2dgs_torch needs a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev
