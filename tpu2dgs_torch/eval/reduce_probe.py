"""Measured comparison of two ways to sum (16,128) planes over their 16
rows on one SM (port of scripts/reduce_probe.py).

    python3 -m tpu2dgs_torch.eval.reduce_probe

The backward blend kernel reduces every record's gradient terms over a
tile's pixels; this probe measures the primitive head to head, so a
redesign of that reduction rests on numbers:

  shuffle  the SIMT way: each thread sums 4 rows of its column, two
           __shfl_xor_sync steps finish the 16 rows
           (`reduce_probe_shuffle`, the counterpart of the TPU probe's
           `kernel_vpu`).
  mma      the tensor-core way: the 16 planes of a step stored into a
           (256,128) slab, split three ways so each part is exact in
           bfloat16, and one {0,1}-selector product per part sums every
           plane's rows at once (`reduce_probe_mma`, the counterpart of
           `kernel_mxu`).

Both compute, for `steps` steps of 16 fresh planes built from a resident
(16,128) input so that nothing can be hoisted,

    acc[x] = sum_{s,k} (k + 1) * sum_y (base[y, x] * f + f),  f = 16 s + k + 1

and return the (128,) row `acc`; element 0 is what the TPU kernels return.
The kernels are in csrc/reduce_probe.cu, one block each. On a CPU tensor
the wrappers run `reduce_probe_plain`; on a CUDA tensor they launch their
kernel or raise. `main` runs on the GPU and raises without one.
"""

from __future__ import annotations

import ctypes
import json

import numpy as np
import torch

from tpu2dgs_torch import default_device
from tpu2dgs_torch.eval.timing import card, cuda_ms
from tpu2dgs_torch.native import build as native

BY, BX = 16, 128
NPLANES = 16
STEPS = 512

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def reduce_probe_plain(base: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    """The plain PyTorch version of both kernels' common function: base
    (16,128) f32 -> acc (128,) f32, on base's device."""
    base = _checked(base)
    k = torch.arange(NPLANES, dtype=torch.float32, device=base.device)
    acc = torch.zeros((BX,), dtype=torch.float32, device=base.device)
    for s in range(steps):
        f = (s * NPLANES + 1 + k)[:, None, None]          # (16,1,1)
        rows = (base[None] * f + f).sum(dim=1)            # (16,128): one row per plane
        for j in range(NPLANES):
            acc = acc + rows[j] * (j + 1)
    return acc


def _checked(base: torch.Tensor) -> torch.Tensor:
    if base.shape != (BY, BX) or base.dtype != torch.float32:
        raise ValueError(f"base must be ({BY},{BX}) float32, got {tuple(base.shape)} "
                         f"{base.dtype}")
    return base.contiguous()


def _run(name: str, base: torch.Tensor, steps: int) -> torch.Tensor:
    base = _checked(base)
    if base.device.type == "cpu":
        return reduce_probe_plain(base, steps)
    if base.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {base.device}")
    acc = torch.empty((BX,), dtype=torch.float32, device=base.device)
    fn = native.function("reduce_probe", f"{name}_launch", _ARGTYPES)
    native.launch(fn, base.data_ptr(), acc.data_ptr(), int(steps), base.device.index or 0,
                  torch.cuda.current_stream(base.device).cuda_stream, what=name)
    return acc


def reduce_probe_shuffle(base: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    """acc (128,) by the warp-shuffle kernel (plain version on the CPU)."""
    return _run("reduce_probe_shuffle", base, steps)


def reduce_probe_mma(base: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    """acc (128,) by the tensor-core kernel (plain version on the CPU)."""
    return _run("reduce_probe_mma", base, steps)


def probe_input(seed: int = 0, device=None) -> torch.Tensor:
    """A uniform [0,1) (16,128) input from `seed`."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((BY, BX), dtype=np.float32)).to(default_device(device))


def run(device=None, steps: int = STEPS) -> dict:
    """Time both kernels; one line each, as the TPU probe prints them."""
    dev = default_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the reduction probe times CUDA kernels: it needs a GPU")
    base = probe_input(0, dev)
    out = {}
    for label, fn in (("A warp-shuffle reduce (SIMT)", reduce_probe_shuffle),
                      ("B selector-matmul (tensor cores)", reduce_probe_mma)):
        ms = cuda_ms(lambda: fn(base, steps))
        per_set = ms * 1e6 / steps
        print(f"{label}: {ms:8.3f} ms/call  {per_set:7.1f} ns per 16-plane reduction set",
              flush=True)
        out[fn.__name__] = {"ms": ms, "ns_per_set": per_set,
                            "acc0": float(fn(base, steps)[0])}
    return out


def main(argv=None, device=None) -> None:
    del argv  # no flags
    result = run(device)
    print(json.dumps({"reduce_probe": result, "steps": STEPS, "card": card()}), flush=True)


if __name__ == "__main__":
    main()
