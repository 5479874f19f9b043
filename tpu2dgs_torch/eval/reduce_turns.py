"""Time the reduction-probe kernels against another version of their
source in one process, and hold every result against a float64 witness.

    python3 -m tpu2dgs_torch.eval.reduce_turns OTHER.cu

OTHER.cu is another version of csrc/reduce_probe.cu (a parent commit's:
`git show <commit>:tpu2dgs_torch/csrc/reduce_probe.cu > .smoke/other/reduce_probe.cu`).
It is built with the port's nvcc flags into a library beside it. For each
kernel the script then times other, this tree's, this tree's, other, each
turn the mean of 20 launches by CUDA events at the probe's 512 steps, so
that a drift of the card's clocks shows in the turns. It prints one JSON
line a kernel, then the card.

The witness is the probe's function in closed form, in float64:

    acc[x] = (sum_y base[y, x] + 16) * sum_{s,k} (k + 1) (16 s + k + 1)

exact to float64's last bits (16 float32 terms and an integer weight below
2^53). Each line gives the kernels' and the plain version's largest error
against it, so a difference between a kernel and the plain version can be
put on the side it belongs to. Runs on the GPU and raises without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from tpu2dgs_torch.eval import reduce_probe
from tpu2dgs_torch.eval.timing import card, cuda_ms
from tpu2dgs_torch.native import build as native

NAMES = ("reduce_probe_shuffle", "reduce_probe_mma")


def reduce_probe_f64(base: torch.Tensor, steps: int = reduce_probe.STEPS) -> torch.Tensor:
    """The probe's row (128,) in float64, by its closed form."""
    s = torch.arange(steps, dtype=torch.float64)[:, None]
    k = torch.arange(reduce_probe.NPLANES, dtype=torch.float64)[None, :]
    weight = float(((k + 1) * (reduce_probe.NPLANES * s + k + 1)).sum())
    return (base.double().sum(dim=0) + reduce_probe.BY) * weight


def build_other(source: Path) -> ctypes.CDLL:
    """OTHER.cu built with the port's flags into a library beside it."""
    lib = source.with_name(f"lib{source.stem}_other.so")
    cmd = [native._nvcc(), *native.NVCC_FLAGS, "-o", str(lib), str(source)]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if done.returncode != 0:
        raise RuntimeError(f"{source} did not build:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(lib))


def max_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float(((got.double().cpu() - ref) / ref).abs().max())


def run(source: Path, steps: int = reduce_probe.STEPS) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the reduction turns time CUDA kernels: they need a GPU")
    other_lib = build_other(source)
    base = reduce_probe.probe_input(0, "cuda")
    witness = reduce_probe_f64(base.cpu(), steps)
    plain = reduce_probe.reduce_probe_plain(base, steps)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name in NAMES:
        launch = other_lib[f"{name}_launch"]
        launch.argtypes = reduce_probe._ARGTYPES
        launch.restype = ctypes.c_int
        other_acc = torch.empty_like(plain)

        def other():
            native.check(launch(base.data_ptr(), other_acc.data_ptr(), steps,
                                base.device.index or 0, stream), f"other {name} launch")

        fn = getattr(reduce_probe, name)
        change = lambda: fn(base, steps)  # noqa: E731
        other()
        got = change()
        torch.cuda.synchronize()
        turns = [cuda_ms(t, reps=20) for t in (other, change, change, other)]
        out[name] = dict(
            steps=steps, ms=(turns[1] + turns[2]) / 2, other_ms=(turns[0] + turns[3]) / 2,
            turns_ms=turns, max_rel_err_vs_plain=max_rel(got, plain.double().cpu()),
            other_max_rel_err_vs_plain=max_rel(other_acc, plain.double().cpu()),
            max_rel_err_vs_f64=max_rel(got, witness),
            other_max_rel_err_vs_f64=max_rel(other_acc, witness),
            plain_max_rel_err_vs_f64=max_rel(plain, witness))
        print(json.dumps({"reduce_turns": name, **out[name]}), flush=True)
    print(json.dumps({"card": card()}), flush=True)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="another version of csrc/reduce_probe.cu")
    run(parser.parse_args(argv).other.resolve())


if __name__ == "__main__":
    main()
