"""Smoke run of the tpu2dgs_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/, holds each against its plain PyTorch
version at the shapes of the 800x800 / 131,072-splat bench scene, then
serves a loaded splat model: a shell scene written with save_ply, read
back with load_ply and rendered through raster.api.render from four
orbit poses, counting the kernel launches of those renders. Each phase
prints one JSON line; the line before the last lists every kernel with
its launches, times and bound, and the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed check exits nonzero before that line. Needs a CUDA device and
nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from tpu2dgs_torch.eval import synthetic
from tpu2dgs_torch.model import splats as splats_lib
from tpu2dgs_torch.native import build as native
from tpu2dgs_torch.raster import api, cuda_backend, preprocess, select_kernel

W = H = 800
N_SPLATS = 1 << 17
# The bench capacities of the JAX package (bench.py): bin 8192, tile 2048,
# column 32768, packed gradient rows 149248.
CAPS = dict(bin_capacity=8192, tile_capacity=2048, col_capacity=32768,
            grad_pack_capacity=149248)
VIEWS = 4

# H100 SXM published peaks (NVIDIA data sheet): device memory rate and the
# float32 rate outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# Operations per (candidate, row) of the select kernel's hit tests and per
# (record, pixel) of the blend, counted from the kernels' source.
BOX_TEST_OPS = 7
EXACT_TEST_OPS = 198
BLEND_OPS = 89

KERNEL_TOL = 1e-5         # blend channels 0-11, max |kernel - plain|
LAST_FLIP_FRAC = 1e-4     # blend channel 12: share of pixels allowed to differ
RENDER_TOL = 2e-4         # served render vs its plain-version render

KEYS = ["render", "rend_alpha", "rend_normal", "rend_dist", "surf_depth",
        "surf_normal", "depth_median"]
OVERFLOW = ["tile_overflow_frac", "bin_overflow_frac", "col_overflow_frac",
            "vis_overflow", "grad_pack_overflow_frac", "tile_count_max"]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool((a.view(torch.int32) == b.view(torch.int32)).all())


def record_calls(module, name, log):
    """Patch module.name with a wrapper that logs its (args, kwargs)."""
    orig = getattr(module, name)

    def recorder(*args, **kwargs):
        log.append((args, kwargs))
        return orig(*args, **kwargs)

    return mock.patch.object(module, name, recorder)


def bench_inputs(settings):
    """One render of the bench scene, keeping the inputs of every select
    level and of the blend."""
    cam, scene = synthetic.make_bench_scene(W, H, N_SPLATS)
    selects, blends = [], []
    with record_calls(select_kernel, "select_values", selects), \
            record_calls(cuda_backend, "blend_tiles", blends):
        out = api.render(cam, settings, *scene, torch.zeros(3, device=scene[0].device))
    if len(selects) != 3 or len(blends) != 1:
        fail(f"bench render made {len(selects)} select and {len(blends)} blend calls")
    return out, selects, blends[0][0]


def select_level(level, args, kwargs):
    """Hold the select kernel against its plain version on one level."""
    got, cnt = select_kernel.select_values(*args, **kwargs)
    ref, ref_cnt = select_kernel.select_values_plain(*args, **kwargs)
    torch.cuda.synchronize()
    if not (bits_equal(got, ref) and torch.equal(cnt, ref_cnt)):
        diff = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        fail(f"select {level}: kernel differs from plain ({diff} values, "
             f"counts equal: {torch.equal(cnt, ref_cnt)})")
    ms = cuda_ms(lambda: select_kernel.select_values(*args, **kwargs), reps=20)
    plain_ms = cuda_ms(lambda: select_kernel.select_values_plain(*args, **kwargs),
                       reps=5, warmup=1)

    # Bound: the tested channels of every parent's walked candidates read
    # once, every output slot and count written once; hit tests of every
    # walked (row, candidate) pair.
    rects, cand, parent, cap = args[0], args[1], args[2], args[3]
    if isinstance(cand, (tuple, list)):
        m = cand[0].shape[-1]
    else:
        m = cand.shape[-1]
    m = -(-m // select_kernel.MACRO) * select_kernel.MACRO
    pcnt = kwargs["parent_counts"].to(torch.int64).clamp(0, m)
    walked = (pcnt + select_kernel.MACRO - 1) // select_kernel.MACRO * select_kernel.MACRO
    per_parent = torch.zeros(int(parent.max()) + 1, dtype=torch.int64, device=walked.device)
    per_parent.scatter_reduce_(0, parent.to(torch.int64), walked, reduce="amax")
    exact = kwargs.get("exact_idx") is not None
    box = kwargs.get("box_idx", (0, 1, 2, 3)) is not None
    n_test = (13 if exact else 0) + (4 if box else 0)
    rows, n_chan = got.shape[0], got.shape[1]
    bytes_ = 4 * (int(per_parent.sum()) * n_test + rows * n_chan * cap + rows * 7)
    ops = int(walked.sum()) * ((EXACT_TEST_OPS if exact else 0) + (BOX_TEST_OPS if box else 0))
    t_bytes, t_ops = bytes_ / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
    info = dict(level=level, rows=rows, out_shape=list(got.shape), cap=cap,
                walked=int(walked.sum()), hits=int(cnt.sum()), max_count=int(cnt.max()),
                ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                max_abs_err=0.0)
    emit({"phase": "kernels", "kernel": "select_values", **info})
    return info


def blend_check(rec3, counts, nty):
    """Hold the blend kernel against its plain version on the bench lists."""
    got = cuda_backend.blend_tiles(rec3, counts, nty)
    ref = cuda_backend.blend_tiles_plain(rec3, counts, nty)
    torch.cuda.synchronize()
    err = float((got[:, :12] - ref[:, :12]).abs().max())
    flips = float((got[:, 12] != ref[:, 12]).to(torch.float32).mean())
    if not (math.isfinite(err) and err <= KERNEL_TOL and flips <= LAST_FLIP_FRAC):
        fail(f"blend: kernel vs plain max|d| {err} (tol {KERNEL_TOL}), "
             f"last-contributor flips {flips} (tol {LAST_FLIP_FRAC})")
    ms = cuda_ms(lambda: cuda_backend.blend_tiles(rec3, counts, nty), reps=20)
    plain_ms = cuda_ms(lambda: cuda_backend.blend_tiles_plain(rec3, counts, nty),
                       reps=2, warmup=1)

    # Bound: a pixel's records must be read up to its tile's last
    # contributor at least; 21 record floats each, read once, the output
    # written once; BLEND_OPS per (record, pixel) pair.
    t = rec3.shape[0]
    needed = (ref[:, 12].amax(dim=(1, 2)) + 1).clamp(min=0).to(torch.int64)
    pairs = int(needed.sum()) * cuda_backend.BY * cuda_backend.BX
    bytes_ = 4 * (int(needed.sum()) * 21 + t + got.numel())
    ops = pairs * BLEND_OPS
    t_bytes, t_ops = bytes_ / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
    info = dict(tiles=t, capk=rec3.shape[2], walked=int(counts.sum()),
                needed=int(needed.sum()), ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                max_abs_err=err, last_flip_frac=flips)
    emit({"phase": "kernels", "kernel": "blend_tiles", **info})
    return info


def serve(settings, out_dir: Path):
    """The main path: load a PLY, answer VIEWS render requests."""
    path = out_dir / "shell.ply"
    _, scene = synthetic.make_shell_scene(W, H, N_SPLATS)
    splats_lib.save_ply(synthetic.scene_model(scene), str(path))
    model = splats_lib.load_ply(str(path))
    path.unlink()
    if int(model.num_live()) != N_SPLATS:
        fail(f"load_ply kept {int(model.num_live())} of {N_SPLATS} live splats")
    p = model.params
    args = (p.xyz, torch.exp(p.scaling), p.rotation, torch.sigmoid(p.opacity[:, 0]),
            splats_lib.features(p))
    bg = torch.zeros(3, device=p.xyz.device)
    cams = [synthetic.shell_camera(2 * np.pi * (0.13 + k / VIEWS), W, H).arrays()
            for k in range(VIEWS)]

    native.LAUNCHES.clear()
    outs, view_ms, per_view = [], [], []
    for cam in cams:
        t0 = time.perf_counter()
        out = api.render(cam, settings, *args, bg, live=model.live)
        torch.cuda.synchronize()
        view_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
        per_view.append((native.LAUNCHES["select_values"], native.LAUNCHES["blend_tiles"]))
    launches = {k: native.LAUNCHES[k] for k in ("select_values", "blend_tiles")}
    if per_view != [(3 * (k + 1), k + 1) for k in range(VIEWS)]:
        fail(f"served renders launched {per_view} (cumulative select, blend), "
             "want 3 selects and 1 blend per view")

    for out in outs:
        for k in KEYS:
            if not bool(torch.isfinite(out[k]).all()):
                fail(f"served render: non-finite {k}")
        if out["render"].shape != (3, H, W) or out["radii"].shape != (model.capacity,) \
                or out["visibility_filter"].shape != (model.capacity,):
            fail("served render: unexpected output shapes")
    if float(outs[0]["rend_alpha"].mean()) < 0.05:
        fail("served render: the shell covers almost nothing")

    # One view against the same render through the plain versions.
    cam = cams[0]
    splats = preprocess.preprocess(*args, cam, W, H, settings.sh_degree, live=model.live)
    image, allmap = cuda_backend.rasterize_cuda(splats, settings, bg, plain=True)
    ref = api.decode_outputs(cam, settings, splats, image, allmap)
    diffs = {k: float((outs[0][k] - ref[k]).abs().max()) for k in KEYS}
    if max(diffs.values()) > RENDER_TOL or not torch.equal(outs[0]["radii"], ref["radii"]):
        fail(f"served render vs plain versions: {diffs}")
    emit({"phase": "serve", "views": VIEWS, "num_live": int(model.num_live()),
          "view_ms": view_ms, "launches": launches, "max_abs_vs_plain": diffs,
          "alpha_mean": [float(o["rend_alpha"].mean()) for o in outs],
          "overflow": [{k: float(o[k]) for k in OVERFLOW} for o in outs]})
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    shutil.rmtree(native.BUILD, ignore_errors=True)  # time a cold build
    native.build_all()
    # ptxas -v lines of each kernel: registers, shared memory, spills
    ptxas = {n: [line.split(":", 1)[-1].strip() for line in
                 native.library_path(n).with_suffix(".log").read_text().splitlines()
                 if "registers" in line or "spill" in line] for n in native.SOURCES}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [native.library_path(n).name for n in native.SOURCES],
          "ptxas": ptxas})

    settings = api.RasterSettings(W, H, **CAPS)
    bench, selects, (rec3, counts, nty) = bench_inputs(settings)
    levels = [select_level(lv, a, k) for lv, (a, k) in zip(("L1", "L2", "L3"), selects)]
    blend = blend_check(rec3, counts, nty)

    out_dir = Path(__file__).resolve().parent / ".smoke"
    out_dir.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    launches = serve(settings, out_dir)
    serve_s = time.perf_counter() - t0

    cam, scene = synthetic.make_bench_scene(W, H, N_SPLATS)
    bg = torch.zeros(3, device=scene[0].device)
    bench_ms = cuda_ms(lambda: api.render(cam, settings, *scene, bg), reps=5, warmup=1)
    emit({"phase": "bench", "render_ms": bench_ms, "serve_seconds": serve_s,
          "overflow": {k: float(bench[k]) for k in OVERFLOW}})

    emit({"kernels": [
        {"name": "select_values", "route": "cuda",
         "source": "tpu2dgs_torch/csrc/select_values.cu",
         "replaces": "tpu2dgs/raster/select_kernel.py:126",
         "tpu_kernel": "tpu2dgs/raster/select_kernel.py:_select_values_kernel",
         "launches": launches["select_values"],
         "max_abs_err": 0.0,
         "ms": sum(lv["ms"] for lv in levels),
         "plain_ms": sum(lv["plain_ms"] for lv in levels),
         "bound_ms": sum(lv["bound_ms"] for lv in levels),
         "bound_by": "bytes" if all(lv["bound_by"] == "bytes" for lv in levels)
         else "operations",
         "library_ms": None,
         "levels": levels},
        {"name": "blend_tiles", "route": "cuda",
         "source": "tpu2dgs_torch/csrc/blend_forward.cu",
         "replaces": "tpu2dgs/raster/pallas_backend.py:203",
         "tpu_kernel": "tpu2dgs/raster/pallas_backend.py:_fwd_kernel",
         "launches": launches["blend_tiles"],
         "max_abs_err": blend["max_abs_err"],
         "ms": blend["ms"], "plain_ms": blend["plain_ms"],
         "bound_ms": blend["bound_ms"], "bound_by": blend["bound_by"],
         "library_ms": None},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
