"""Smoke run of the tpu2dgs_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/, holds each against its plain PyTorch
version at the shapes of the 800x800 / 131,072-splat bench scene, then
drives the two main paths. Serving: a shell scene written with save_ply,
read back with load_ply and rendered through raster.api.render from four
orbit poses. Training: train.loop.Trainer takes 24 steps on the shell
scene from a perturbed start, with all three loss terms on, two
densification rounds, capacity growth and the overflow healing checks,
and one of its gradients is held against the same gradient through the
plain versions. Both count the kernel launches they make. Each phase
prints one JSON line; the line before the last but one lists every kernel
with its launches, times and bound, and the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed check exits nonzero before that line. Needs a CUDA device and
nvcc; imports nothing of JAX. `python3 chip_smoke.py kernels` stops after
the kernel checks and prints no verdict.
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
from tpu2dgs_torch.train import loop

W = H = 800
N_SPLATS = 1 << 17
# The bench capacities of the JAX package (bench.py): bin 8192, tile 2048,
# column 32768, packed gradient rows 149248.
CAPS = dict(bin_capacity=8192, tile_capacity=2048, col_capacity=32768,
            grad_pack_capacity=149248)
VIEWS = 4
# Capacities with room for every list of the shell scene: its ground-truth
# images are rendered untruncated, so the trainer, which starts from the
# bench capacities, renders them better once its healing has raised them.
GT_CAPS = dict(bin_capacity=20480, tile_capacity=10240, col_capacity=61440)
TRAIN_STEPS = 24
TRAIN_VIEWS = 4  # one epoch of the camera shuffle: first and last 4 steps see every view

# H100 SXM published peaks (NVIDIA data sheet): device memory rate and the
# float32 rate outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# Operations per (candidate, row) of the select kernel's hit tests and per
# (record, pixel) of the blend, counted from the kernels' source.
BOX_TEST_OPS = 7
EXACT_TEST_OPS = 198
BLEND_OPS = 89
# Backward blend: the response and hit test of every (record, pixel) pair,
# and for a pair that blended, the gradient arithmetic plus one add per
# channel into the record's row.
BWD_RESPONSE_OPS = 48
BWD_BLENDED_OPS = 145

KERNEL_TOL = 1e-5         # blend channels 0-11, max |kernel - plain|
LAST_FLIP_FRAC = 1e-4     # blend channel 12: share of pixels allowed to differ
RENDER_TOL = 2e-4         # served render vs its plain-version render
# Backward blend. Kernel and plain version compute each pixel's terms in the
# same order; they differ in the order of the sum over a tile's 2048 pixels
# (and, after the scatter, of index_add_'s atomics), and the walk's division
# by 1 - alpha amplifies a last-bit difference a hundredfold.
BWD_ROW_TOL = 1e-3        # packed row: max |kernel - plain| / the row's largest |value|
BWD_SCATTER_TOL = 1e-4    # scattered (K, 19) gradient: max |d| / max |gradient|
# Training gradient through the kernels against plain, per parameter:
# max |d| <= GRAD_TOL x that parameter's max |gradient|, or <= GRAD_FLOOR x
# the largest gradient of any parameter. Every parameter's gradient is a
# chain-rule sum of the same record gradients, so float32 rounding of the
# largest terms (the rotation's, ~0.6) is an absolute floor under all of
# them: the log-scale gradient (~3e-5, a d/dscale times a scale of ~0.004)
# cancels down to 1e-3 of its own size there.
GRAD_TOL = 1e-3
GRAD_FLOOR = 1e-6

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


@torch.no_grad()
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


def blended_pairs(rec3, counts, out, nty) -> int:
    """(record, pixel) pairs that blended: what the backward must
    differentiate. All tiles in lockstep, the forward's hit test."""
    t = rec3.shape[0]
    px, py = cuda_backend._tile_planes(t, nty, rec3.device)
    last = out[:, 12]
    total = torch.zeros((), dtype=torch.int64, device=rec3.device)
    for j in range(int(last.max()) + 1):
        r = [rec3[:, k, j, None, None] for k in range(21)]
        hit = cuda_backend._splat_response(r, px, py)[2]
        total += torch.sum(hit & (float(j) <= last) & (j < counts)[:, None, None])
    return int(total)


def backward_check(rec3, counts, nty):
    """Hold the backward blend kernel against its plain version on the
    bench lists, with room in the packed array and with too little."""
    dev = rec3.device
    t, _, capk = rec3.shape
    out = cuda_backend.blend_tiles(rec3, counts, nty)
    gen = torch.Generator(device=dev).manual_seed(0)
    dout = torch.randn(out.shape, device=dev, generator=gen)
    dout[:, 9] *= 0.01  # the distortion map's cotangent is small in training
    grp = min(cuda_backend.GROUP, capk)
    eff = cuda_backend._effective_counts(counts, out, grp)
    off = cuda_backend._packed_offsets(counts, out, grp)
    ref_off = (torch.cumsum(eff, 0) - eff).to(torch.int32)
    if not torch.equal(off, ref_off) or bool((off % grp != 0).any()):
        fail("backward: packed offsets are not the group-aligned exclusive prefix sum")
    demand = int(eff.sum())
    n_rec = N_SPLATS
    cases = {"room": -(-demand // grp) * grp + grp,
             "overflow": max(grp, (demand // 2) // grp * grp)}
    info = {}
    for name, pack_cap in cases.items():
        args = (rec3, counts, off, out, dout, nty, pack_cap)
        got = cuda_backend.blend_tiles_backward(*args)
        again = cuda_backend.blend_tiles_backward(*args)
        ref = cuda_backend.blend_tiles_backward_plain(*args)
        torch.cuda.synchronize()
        written = min(demand, pack_cap)
        g, a, r = got[:written], again[:written], ref[:written]
        if not bits_equal(g, a):
            fail(f"backward {name}: two launches on the same inputs differ")
        if not torch.equal(g[:, 19], r[:, 19]):
            fail(f"backward {name}: slot column differs from plain "
                 f"({int((g[:, 19] != r[:, 19]).sum())} rows)")
        row_scale = r[:, :19].abs().amax(dim=1).clamp(min=1e-30)
        row_err = float(((g[:, :19] - r[:, :19]).abs().amax(dim=1) / row_scale).max())
        gs = cuda_backend.scatter_packed(got, eff, n_rec)
        gs2 = cuda_backend.scatter_packed(got, eff, n_rec)
        rs = cuda_backend.scatter_packed(ref, eff, n_rec)
        scale = float(rs.abs().max())
        err = float((gs - rs).abs().max())
        rerun = float((gs - gs2).abs().max())
        if not (math.isfinite(row_err) and row_err <= BWD_ROW_TOL
                and math.isfinite(err) and err <= BWD_SCATTER_TOL * scale):
            fail(f"backward {name}: kernel vs plain row error {row_err} (tol {BWD_ROW_TOL}), "
                 f"scattered max|d| {err} against max|grad| {scale} (tol {BWD_SCATTER_TOL})")
        if float(gs[:, 19:].abs().max()) != 0.0:
            fail(f"backward {name}: record channels 19:24 received a gradient")
        info[name] = dict(pack_cap=pack_cap, written=written, row_rel_err=row_err,
                          max_abs_err=err, grad_max=scale, scatter_rerun_max_abs=rerun)
    if cases["overflow"] >= demand:
        fail("backward: the overflow case has room")

    args = (rec3, counts, off, out, dout, nty, cases["room"])
    ms = cuda_ms(lambda: cuda_backend.blend_tiles_backward(*args), reps=20)
    got = cuda_backend.blend_tiles_backward(*args)
    scatter_ms = cuda_ms(lambda: cuda_backend.scatter_packed(got, eff, n_rec), reps=20)
    plain_ms = cuda_ms(lambda: cuda_backend.blend_tiles_backward_plain(*args),
                       reps=1, warmup=0)

    # Bound: the 22 read channels of every record up to its tile's last
    # contributor, out and dout read once, the reserved rows written once;
    # the response of every such (record, pixel) pair and the gradient
    # arithmetic of the pairs that blended.
    needed = (out[:, 12].amax(dim=(1, 2)) + 1).clamp(min=0).to(torch.int64)
    pairs = int(needed.sum()) * cuda_backend.BY * cuda_backend.BX
    blended = blended_pairs(rec3, counts, out, nty)
    bytes_ = 4 * (int(needed.sum()) * 22 + 2 * t + 2 * out.numel()
                  + demand * cuda_backend.OUTREC)
    ops = pairs * BWD_RESPONSE_OPS + blended * BWD_BLENDED_OPS
    t_bytes, t_ops = bytes_ / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
    info.update(tiles=t, capk=capk, group=grp, demand=demand, needed=int(needed.sum()),
                blended_pairs=blended, ms=ms, scatter_ms=scatter_ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                max_abs_err=info["room"]["max_abs_err"])
    emit({"phase": "kernels", "kernel": "blend_tiles_backward", **info})
    return info


def train(caps):
    """The training main path: the Trainer at full width on the shell
    scene, from a perturbed start."""
    t0 = time.perf_counter()
    raster_kwargs = dict(caps, grad_pack_capacity=0)  # the derived default; healing may raise it
    cams, model = synthetic.make_shell_training_set(W, H, N_SPLATS, views=TRAIN_VIEWS,
                                                    **GT_CAPS)
    cfg = loop.TrainConfig(
        normal_from_iter=0, dist_from_iter=0, lambda_dist=100.0,
        densify_from_iter=4, densification_interval=12, opacity_reset_interval=10_000,
        loss_sync_interval=12)
    events, launches, losses = [], [], []

    def log_fn(it, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        launches.append(dict(native.LAUNCHES))
        losses.append({k: metrics[k] for k in ("loss", "l1", "normal", "dist")})

    trainer = loop.Trainer(model, cams, W, H, spatial_lr_scale=1.0, scene_extent=1.0,
                           train_cfg=cfg, raster_kwargs=raster_kwargs, log_fn=log_fn)
    trainer.active_sh_degree = 3  # full width, as a resumed run trains
    setup_s = time.perf_counter() - t0

    native.LAUNCHES.clear()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    trainer.train(num_iters=TRAIN_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    total = dict(native.LAUNCHES)

    names = ("select_values", "blend_tiles", "blend_tiles_backward")
    prev = dict.fromkeys(names, 0)
    for it, snap in enumerate(launches, 1):
        step = tuple(snap.get(k, 0) - prev[k] for k in names)
        if step != (3, 1, 1):
            fail(f"train step {it} launched {dict(zip(names, step))}, want 3 / 1 / 1")
        prev = {k: snap.get(k, 0) for k in names}
    step_ms = [a.elapsed_time(b) for a, b in zip([start, *events], events)]

    loss = [{k: float(v) for k, v in d.items()} for d in losses]
    if not all(math.isfinite(v) for d in loss for v in d.values()):
        fail(f"train: non-finite loss {loss}")
    first = float(np.mean([d["loss"] for d in loss[:TRAIN_VIEWS]]))
    last = float(np.mean([d["loss"] for d in loss[-TRAIN_VIEWS:]]))
    if not last < first:
        fail(f"train: loss did not fall: first epoch {first}, last epoch {last}")
    m, adam = trainer.model, trainer.adam
    for name, a in [*m.params._asdict().items(),
                    *((f"mu.{k}", v) for k, v in adam.mu._asdict().items()),
                    *((f"nu.{k}", v) for k, v in adam.nu._asdict().items())]:
        if not bool(torch.isfinite(a).all()):
            fail(f"train: non-finite {name}")
    if adam.count != TRAIN_STEPS or trainer.last_densify is None:
        fail(f"train: {adam.count} Adam steps, densify info {trainer.last_densify}")

    # render_view makes its own 3 + 1 launches and no backward launch.
    native.LAUNCHES.clear()
    view = trainer.render_view(cams[0])
    torch.cuda.synchronize()
    if dict(native.LAUNCHES) != {"select_values": 3, "blend_tiles": 1}:
        fail(f"render_view launched {dict(native.LAUNCHES)}")
    if view["render"].shape != (3, H, W) or not bool(torch.isfinite(view["render"]).all()):
        fail("render_view: unexpected output")
    psnr = float(loop.losses.psnr(view["render"], trainer._gt_images[0]))

    # One full-width gradient through the kernels against the same through
    # their plain versions, on the trained model.
    settings = trainer._settings()
    gargs = (m, settings, trainer._cam_arrays[0], trainer._gt_images[0], trainer.bg,
             cfg.lambda_dssim, cfg.lambda_normal, cfg.lambda_dist)
    _, _, gk, gk_off = loop.view_gradients(*gargs)
    _, _, gk2, gk2_off = loop.view_gradients(*gargs)
    _, _, gp, gp_off = loop.view_gradients(*gargs, plain=True)
    torch.cuda.synchronize()
    grad_err = {}
    for name, a, a2, b in [*zip(gk._fields, gk, gk2, gp),
                           ("mean2d_offset", gk_off, gk2_off, gp_off)]:
        scale = float(b.abs().max())
        grad_err[name] = {"max_abs_err": float((a - b).abs().max()), "grad_max": scale,
                          "rerun_max_abs": float((a - a2).abs().max())}
    floor = GRAD_FLOOR * max(v["grad_max"] for v in grad_err.values())
    bad = {k: v for k, v in grad_err.items()
           if not (math.isfinite(v["max_abs_err"]) and v["grad_max"] > 0.0
                   and v["max_abs_err"] <= max(GRAD_TOL * v["grad_max"], floor))}
    if bad:
        fail(f"train: gradients through the kernels differ from plain (tol {GRAD_TOL} of "
             f"max|grad|, floor {floor}): {bad}; all: {grad_err}")

    steady = sorted(step_ms[1:])  # the first step warms up the allocator
    emit({"phase": "train", "steps": TRAIN_STEPS, "views": TRAIN_VIEWS,
          "setup_seconds": setup_s, "train_seconds": train_s,
          "iterations_per_s": TRAIN_STEPS / train_s,
          "mpix_per_s": TRAIN_STEPS * W * H / train_s / 1e6,
          "step_ms_median": steady[len(steady) // 2], "step_ms_min": steady[0],
          "step_ms_max": steady[-1], "step_ms": step_ms,
          "launches": total, "loss": [d["loss"] for d in loss],
          "loss_first_epoch": first, "loss_last_epoch": last, "loss_terms_last": loss[-1],
          "psnr_view0": psnr, "capacity": m.capacity, "num_live": int(m.num_live()),
          "densify": {k: int(v) for k, v in trainer.last_densify._asdict().items()},
          "cap_growth_events": trainer.cap_growth_events,
          "raster_kwargs": trainer.raster_kwargs,
          "overflow": {k: float(view[k]) for k in OVERFLOW},
          "grad_vs_plain": grad_err})
    return total


@torch.no_grad()
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
    t_start = time.perf_counter()
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
    bwd = backward_check(rec3, counts, nty)
    if sys.argv[1:] == ["kernels"]:
        return  # `python3 chip_smoke.py kernels`: build and kernel checks only, no verdict

    out_dir = Path(__file__).resolve().parent / ".smoke"
    out_dir.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    launches = serve(settings, out_dir)
    serve_s = time.perf_counter() - t0

    cam, scene = synthetic.make_bench_scene(W, H, N_SPLATS)
    bg = torch.zeros(3, device=scene[0].device)
    with torch.no_grad():
        bench_ms = cuda_ms(lambda: api.render(cam, settings, *scene, bg), reps=5, warmup=1)
    emit({"phase": "bench", "render_ms": bench_ms, "serve_seconds": serve_s,
          "overflow": {k: float(bench[k]) for k in OVERFLOW}})

    t0 = time.perf_counter()
    train_launches = train({k: v for k, v in CAPS.items() if k != "grad_pack_capacity"})
    emit({"phase": "seconds", "serve": serve_s, "train": time.perf_counter() - t0,
          "total": time.perf_counter() - t_start})

    emit({"kernels": [
        {"name": "select_values", "route": "cuda",
         "source": "tpu2dgs_torch/csrc/select_values.cu",
         "replaces": "tpu2dgs/raster/select_kernel.py:126",
         "tpu_kernel": "tpu2dgs/raster/select_kernel.py:_select_values_kernel",
         "launches": launches["select_values"] + train_launches["select_values"],
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
         "launches": launches["blend_tiles"] + train_launches["blend_tiles"],
         "max_abs_err": blend["max_abs_err"],
         "ms": blend["ms"], "plain_ms": blend["plain_ms"],
         "bound_ms": blend["bound_ms"], "bound_by": blend["bound_by"],
         "library_ms": None},
        {"name": "blend_tiles_backward", "route": "cuda",
         "source": "tpu2dgs_torch/csrc/blend_backward.cu",
         "replaces": "tpu2dgs/raster/pallas_backend.py:328",
         "tpu_kernel": "tpu2dgs/raster/pallas_backend.py:_bwd_kernel",
         "launches": train_launches["blend_tiles_backward"],
         "max_abs_err": bwd["max_abs_err"],
         "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
         "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
         "library_ms": None},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
