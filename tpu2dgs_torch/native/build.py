"""Build the CUDA kernels in csrc/ and bind them with ctypes.

Each csrc/<name>.cu exposes a plain C launcher (no PyTorch headers, so
nvcc takes seconds, not minutes) and is compiled on first use into its
own shared library under csrc/build/, a directory .gitignore lists:

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
       -shared -Xcompiler -fPIC -Xptxas -v
       -o csrc/build/lib<name>-<hash>.so csrc/<name>.cu

nvcc's output, with ptxas's registers, shared memory and spills per
kernel, is kept beside the library as lib<name>-<hash>.log.

`--fmad=false` keeps every multiply and add separately rounded, as the
plain PyTorch versions compute them, so the select kernel's coverage test
decides boundary cases exactly as its plain version does. The file name
carries a hash of the source, of every header in csrc/ (kernels share
hit_test.cuh and blend_common.cuh) and of the flags, so an edited source or header is never
served a stale library. `build_all()` starts one nvcc per source, all at
once, and waits for them together.

A launcher takes device pointers, sizes, the CUDA device index and the
stream as arguments and returns cudaGetLastError() after the launch; the
wrappers raise on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = CSRC / "build"
SOURCES = ("select_values", "blend_forward", "blend_backward", "select_counts",
           "reduce_probe")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}

# Kernel launches by wrapper name ("select_values", "blend_tiles",
# "blend_tiles_backward", "select_counts", "reduce_probe_shuffle",
# "reduce_probe_mma"), counted by launch(); a caller that wants the launches
# of one run clears it first.
LAUNCHES: Counter = Counter()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH, /usr/local/cuda/bin): the CUDA kernels of "
            "tpu2dgs_torch are built from csrc/ on the machine with the GPU")
    return nvcc


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = h.hexdigest()[:16]
    return BUILD / f"lib{name}-{tag}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing


def build_all(names=SOURCES) -> None:
    """Compile every missing library, one nvcc per source, in parallel."""
    jobs = {name: _start(name) for name in names}
    errors = []
    for name, job in jobs.items():
        if job is not None:
            try:
                _finish(name, job)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def build_other(source: Path) -> ctypes.CDLL:
    """Another version of a csrc/ source, with the headers it includes
    beside it, built with the port's flags into lib<stem>_other.so beside
    it (nvcc's report in the .log beside that): the other side of a
    comparison in turns."""
    lib = source.with_name(f"lib{source.stem}_other.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(source)]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if done.returncode != 0:
        raise RuntimeError(f"{source} did not build:\n{done.stdout}{done.stderr}")
    lib.with_suffix(".log").write_text(done.stdout + done.stderr)
    return ctypes.CDLL(str(lib))


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C launcher `symbol` of csrc/<name>.cu, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    """Raise on a nonzero CUDA error code returned by a C function."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


def launch(fn, *args, what: str) -> None:
    """Call a C launcher, raise on a nonzero cudaGetLastError(), and count
    the launch under `what`."""
    check(fn(*args), f"{what} kernel launch")
    LAUNCHES[what] += 1
