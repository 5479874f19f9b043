"""Smoke run of the tpu2dgs_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ (and the host's Morton KNN), holds each
of the six kernels against its plain PyTorch version (the select, count
and blend kernels at the shapes of the 800x800 / 131,072-splat bench
scene, the reduction probes at their own 512 steps), then drives every
main path:

  probes   eval.bin_probe and eval.reduce_probe end to end.
  serving  a shell scene written with save_ply, read back with load_ply
           and rendered through raster.api.render from four orbit poses.
  training train.loop.Trainer takes 24 steps on the shell scene from a
           perturbed start, with all three loss terms on, two
           densification rounds, capacity growth and the overflow healing
           checks, and one of its gradients is held against the same
           gradient through the plain versions.
  cli      the shell training set written to disk as a COLMAP dataset,
           cli.train from a fresh start with its ground truth kept on the
           host, a resume from its checkpoint at full width, cli.render
           and cli.metrics on the model directory.

Each path counts the kernel launches it makes, from zero. Each phase
prints one JSON line; the line before the last but one lists every kernel
with its launches, times and bound, and the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed check exits nonzero before that line. Needs a CUDA device, nvcc
and g++; imports nothing of JAX. `python3 chip_smoke.py kernels` stops
after the kernel checks and prints no verdict.
"""

from __future__ import annotations

import contextlib
import json
import math
import shutil
import sys
import time
from collections import Counter
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from tpu2dgs_torch.cli import metrics as cli_metrics
from tpu2dgs_torch.cli import render as cli_render
from tpu2dgs_torch.cli import train as cli_train
from tpu2dgs_torch.core.cameras import fov2focal
from tpu2dgs_torch.core.sh import sh_to_rgb
from tpu2dgs_torch.data import colmap
from tpu2dgs_torch.data.paths import save_img_u8
from tpu2dgs_torch.data.scene import Scene
from tpu2dgs_torch.eval import bin_probe, reduce_probe, synthetic
from tpu2dgs_torch.eval.timing import card, cuda_ms
from tpu2dgs_torch.model import splats as splats_lib
from tpu2dgs_torch.native import build as native
from tpu2dgs_torch.native import knn as native_knn
from tpu2dgs_torch.raster import api, cuda_backend, preprocess, select_kernel
from tpu2dgs_torch.train import checkpoint, loop

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
# The command-line phase: 4 views on disk (3 to train on, 1 held out), a
# fresh run of 12 iterations with a checkpoint at 10, a resumed run of 10.
CLI_VIEWS = 4
CLI_STEPS = (12, 10)
CLI_RESUME_STEPS = 10

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
# Reduction probes against plain, per element of the (128,) row, relative:
# all three sum the same 8192 float32 terms per column in different orders.
REDUCE_TOL = 1e-5
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


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool((a.view(torch.int32) == b.view(torch.int32)).all())


def bound(bytes_: int, ops: int) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the f32 operations over the peak rate."""
    t_bytes, t_ops = bytes_ / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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


def select_walk(kwargs):
    """What a select level's rows walk and what must be read for them:
    (walked candidates per row, candidates read per parent summed over the
    parents, tested channels, operations per test)."""
    cand = kwargs["cand_channels"]
    m = (cand[0] if isinstance(cand, (tuple, list)) else cand).shape[-1]
    m = -(-m // select_kernel.MACRO) * select_kernel.MACRO
    parent = kwargs["parent_of_row"]
    pcnt = kwargs["parent_counts"].to(torch.int64).clamp(0, m)
    walked = (pcnt + select_kernel.MACRO - 1) // select_kernel.MACRO * select_kernel.MACRO
    per_parent = torch.zeros(int(parent.max()) + 1, dtype=torch.int64, device=walked.device)
    per_parent.scatter_reduce_(0, parent.to(torch.int64), walked, reduce="amax")
    exact = kwargs.get("exact_idx") is not None
    box = kwargs.get("box_idx", (0, 1, 2, 3)) is not None
    n_test = (13 if exact else 0) + (4 if box else 0)
    test_ops = (EXACT_TEST_OPS if exact else 0) + (BOX_TEST_OPS if box else 0)
    return walked, int(per_parent.sum()), n_test, test_ops


def launcher_ms(launch, kwargs, cap) -> float:
    """Device time of a select kernel alone: its arguments prepared once,
    the launcher called 200 times back to back. `ms` in the lines below is
    the wrapper's time as a caller pays it, argument handling included,
    and for kernels this short that is the host's time, not the card's."""
    box_idx = kwargs.get("box_idx", (0, 1, 2, 3))
    rects, stacked, parent, pcnt, pads = select_kernel._prepare(
        kwargs["row_rects"], kwargs["cand_channels"], kwargs["parent_of_row"],
        cap or select_kernel.LB, kwargs["parent_counts"], kwargs.get("pad_vals"), box_idx)
    exact_idx = kwargs.get("exact_idx")
    if cap is None:
        return cuda_ms(lambda: launch(rects, stacked, parent, pcnt, box_idx, exact_idx),
                       reps=200)
    return cuda_ms(lambda: launch(rects, stacked, parent, pcnt, cap, pads, box_idx,
                                  exact_idx), reps=200)


def select_level(level, kwargs):
    """Hold the select kernel against its plain version on one level."""
    got, cnt = select_kernel.select_values(**kwargs)
    ref, ref_cnt = select_kernel.select_values_plain(**kwargs)
    torch.cuda.synchronize()
    if not (bits_equal(got, ref) and torch.equal(cnt, ref_cnt)):
        diff = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        fail(f"select {level}: kernel differs from plain ({diff} values, "
             f"counts equal: {torch.equal(cnt, ref_cnt)})")
    ms = cuda_ms(lambda: select_kernel.select_values(**kwargs), reps=20)
    plain_ms = cuda_ms(lambda: select_kernel.select_values_plain(**kwargs),
                       reps=5, warmup=1)
    kernel_ms = launcher_ms(select_kernel._launch, kwargs, kwargs["cap"])

    # Bound: the tested channels of every parent's walked candidates read
    # once, every output slot and count written once; hit tests of every
    # walked (row, candidate) pair.
    walked, read, n_test, test_ops = select_walk(kwargs)
    cap = kwargs["cap"]
    rows, n_chan = got.shape[0], got.shape[1]
    bytes_ = 4 * (read * n_test + rows * n_chan * cap + rows * 7)
    ops = int(walked.sum()) * test_ops
    bound_ms, bound_by = bound(bytes_, ops)
    info = dict(level=level, rows=rows, out_shape=list(got.shape), cap=cap,
                walked=int(walked.sum()), hits=int(cnt.sum()), max_count=int(cnt.max()),
                ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=0.0)
    emit({"phase": "kernels", "kernel": "select_values", **info})
    return info, cnt


def count_level(level, kwargs, k1_counts):
    """Hold the count-only select kernel against its plain version and
    against the counts the select kernel returned for the same level."""
    kwargs = {k: v for k, v in kwargs.items() if k != "cap"}
    got = select_kernel.select_counts(**kwargs)
    again = select_kernel.select_counts(**kwargs)
    ref = select_kernel.select_counts_plain(**kwargs)
    torch.cuda.synchronize()
    for name, other in (("plain", ref), ("select_values' counts", k1_counts),
                        ("a second launch", again)):
        if got.dtype != torch.int32 or not torch.equal(got, other.to(torch.int32)):
            fail(f"count {level}: kernel differs from {name} in "
                 f"{int((got != other).sum())} of {got.numel()} rows")
    ms = cuda_ms(lambda: select_kernel.select_counts(**kwargs), reps=20)
    plain_ms = cuda_ms(lambda: select_kernel.select_counts_plain(**kwargs), reps=5, warmup=1)
    kernel_ms = launcher_ms(select_kernel._count_launch, kwargs, None)

    # Bound: as the select kernel's, with one count written per row and no
    # output slots.
    walked, read, n_test, test_ops = select_walk(kwargs)
    rows = got.shape[0]
    bytes_ = 4 * (read * n_test + rows * 7)
    ops = int(walked.sum()) * test_ops
    bound_ms, bound_by = bound(bytes_, ops)
    info = dict(level=level, rows=rows, walked=int(walked.sum()), hits=int(got.sum()),
                ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=0.0)
    emit({"phase": "kernels", "kernel": "select_counts", **info})
    return info


def reduce_check():
    """Hold both reduction-probe kernels against their plain version at the
    probe's own size (512 steps of 16 planes)."""
    steps = reduce_probe.STEPS
    base = reduce_probe.probe_input(0)
    ref = reduce_probe.reduce_probe_plain(base, steps)
    plain_ms = cuda_ms(lambda: reduce_probe.reduce_probe_plain(base, steps), reps=1, warmup=0)
    # What one PyTorch call can do of this function: the row sums of the
    # planes once they exist. It reads them from device memory, which the
    # kernels never do, and leaves out their making and the weighted sum, so
    # it is reported beside the kernels and not as their library time.
    f = torch.arange(1, steps * reduce_probe.NPLANES + 1, dtype=torch.float32,
                     device=base.device)[:, None, None]
    planes = base[None] * f + f
    planes_sum_ms = cuda_ms(lambda: planes.sum(dim=1), reps=20)
    del planes
    # Bound: per step 16 planes of 2048 values, each built (a multiply and
    # an add) and summed (an add), and 16 rows of 128 weighted and added.
    ops = steps * (reduce_probe.NPLANES * reduce_probe.BY * reduce_probe.BX * 3
                   + reduce_probe.NPLANES * reduce_probe.BX * 2)
    bytes_ = 4 * (reduce_probe.BY * reduce_probe.BX + reduce_probe.BX)
    bound_ms, bound_by = bound(bytes_, ops)
    infos = {}
    for name in ("reduce_probe_shuffle", "reduce_probe_mma"):
        fn = getattr(reduce_probe, name)
        got = fn(base, steps)
        again = fn(base, steps)
        torch.cuda.synchronize()
        rel = float(((got - ref).abs() / ref.abs()).max())
        if not (math.isfinite(rel) and rel <= REDUCE_TOL and bits_equal(got, again)):
            fail(f"{name}: max relative error {rel} against plain (tol {REDUCE_TOL}), "
                 f"two launches equal: {bits_equal(got, again)}")
        ms = cuda_ms(lambda: fn(base, steps), reps=20)
        infos[name] = dict(steps=steps, acc0=float(got[0]), plain_acc0=float(ref[0]),
                           max_rel_err=rel, max_abs_err=float((got - ref).abs().max()),
                           ms=ms, ns_per_set=ms * 1e6 / steps, plain_ms=plain_ms,
                           planes_sum_ms=planes_sum_ms, bound_ms=bound_ms, bound_by=bound_by)
        emit({"phase": "kernels", "kernel": name, **infos[name]})
    return infos


def pair_counts(rec3, counts, out, nty) -> tuple[int, int]:
    """(hit pairs, blended pairs) of the lists: (record, pixel) pairs that
    pass the blend's hit test at or before their tile's last contributor,
    and of those the pairs that blended (at or before the pixel's own last
    contributor). All tiles in lockstep, the forward's hit test."""
    t = rec3.shape[0]
    px, py = cuda_backend._tile_planes(t, nty, rec3.device)
    last = out[:, 12]
    tile_last = last.amax(dim=(1, 2))
    hits = torch.zeros((), dtype=torch.int64, device=rec3.device)
    blended = torch.zeros((), dtype=torch.int64, device=rec3.device)
    for j in range(int(last.max()) + 1):
        r = [rec3[:, k, j, None, None] for k in range(21)]
        hit = cuda_backend._splat_response(r, px, py)[2]
        hit = hit & ((j < counts) & (float(j) <= tile_last))[:, None, None]
        hits += torch.sum(hit)
        blended += torch.sum(hit & (float(j) <= last))
    return int(hits), int(blended)


def cull_share(rec3, counts, nty, rows=cuda_backend.BY) -> float:
    """Share of the live (record, block) pairs that exact coverage keeps:
    with rows = 16 the blocks are the 16x16 sub-tiles, with rows = 4 the
    16x4 blocks of the warps, the cull the blend kernels run."""
    kept = int(cuda_backend.subtile_coverage(rec3, counts, nty, rows).sum())
    blocks = cuda_backend.BX // cuda_backend.SUB * (cuda_backend.BY // rows)
    return kept / max(1, int(counts.to(torch.int64).sum()) * blocks)


def cull_shares(rec3, counts, nty) -> dict:
    return {"cull_pass_share": cull_share(rec3, counts, nty),
            "cull_warp_pass_share": cull_share(rec3, counts, nty, rows=4)}


def longest_alone(counts, out):
    """The tile with the longest walk (out channel 12), and the counts and
    out that leave every other tile empty: a blend kernel given them times
    that tile alone."""
    last = out[:, 12].amax(dim=(1, 2))
    keep = torch.arange(counts.shape[0], device=counts.device) == int(torch.argmax(last))
    alone_out = out.clone()
    alone_out[:, 12] = torch.where(keep[:, None, None], out[:, 12], -1.0)
    return torch.where(keep, counts, 0).to(counts.dtype), alone_out


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
    alone_counts, _ = longest_alone(counts, ref)
    longest_ms = cuda_ms(lambda: cuda_backend.blend_tiles(rec3, alone_counts, nty), reps=20)

    # Bound: a pixel's records must be read up to its tile's last
    # contributor at least; 21 record floats each, read once, the output
    # written once; BLEND_OPS per hit pair, the pairs that must be blended
    # or killed. `bound_all_pairs_ms` counts every pair up to the tile's
    # last contributor, as a kernel without a cull computes them.
    t = rec3.shape[0]
    needed = (ref[:, 12].amax(dim=(1, 2)) + 1).clamp(min=0).to(torch.int64)
    pairs = int(needed.sum()) * cuda_backend.BY * cuda_backend.BX
    hits, blended = pair_counts(rec3, counts, ref, nty)
    bytes_ = 4 * (int(needed.sum()) * 21 + t + got.numel())
    bound_ms, bound_by = bound(bytes_, hits * BLEND_OPS)
    info = dict(tiles=t, capk=rec3.shape[2], walked=int(counts.sum()),
                needed=int(needed.sum()), pairs=pairs, hit_pairs=hits, blended_pairs=blended,
                **cull_shares(rec3, counts, nty), ms=ms, longest_tile_ms=longest_ms,
                plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                bound_all_pairs_ms=bound(bytes_, pairs * BLEND_OPS)[0],
                max_abs_err=err, last_flip_frac=flips)
    emit({"phase": "kernels", "kernel": "blend_tiles", **info})
    return info


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
    alone_counts, alone_out = longest_alone(counts, out)
    alone_args = (rec3, alone_counts, off, alone_out, dout, nty, cases["room"])
    longest_ms = cuda_ms(lambda: cuda_backend.blend_tiles_backward(*alone_args), reps=20)

    # Bound: the 22 read channels of every record up to its tile's last
    # contributor, the planes of out (3, 10, 11, 12) and dout (0-9) the walk
    # reads, each once, the reserved rows written once;
    # the response of every hit pair and the gradient arithmetic of the pairs
    # that blended. `bound_all_pairs_ms` takes the response of every pair up
    # to the tile's last contributor, as a kernel without a cull computes it.
    needed = (out[:, 12].amax(dim=(1, 2)) + 1).clamp(min=0).to(torch.int64)
    pairs = int(needed.sum()) * cuda_backend.BY * cuda_backend.BX
    hits, blended = pair_counts(rec3, counts, out, nty)
    plane = cuda_backend.BY * cuda_backend.BX
    bytes_ = 4 * (int(needed.sum()) * 22 + 2 * t + t * plane * (4 + 10)
                  + demand * cuda_backend.OUTREC)
    bound_ms, bound_by = bound(bytes_, hits * BWD_RESPONSE_OPS + blended * BWD_BLENDED_OPS)
    info.update(tiles=t, capk=capk, group=grp, demand=demand, needed=int(needed.sum()),
                pairs=pairs, hit_pairs=hits, blended_pairs=blended, ms=ms,
                longest_tile_ms=longest_ms,
                scatter_ms=scatter_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bound_all_pairs_ms=bound(bytes_, pairs * BWD_RESPONSE_OPS
                                         + blended * BWD_BLENDED_OPS)[0],
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


def probes():
    """The two probe entry points end to end: the per-level binning probe
    at the bench scene (the select kernel three times and the count-only
    kernel twice per pass) and the reduction probe (both kernels)."""
    native.LAUNCHES.clear()
    t0 = time.perf_counter()
    binning = bin_probe.run()
    reduction = reduce_probe.run()
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    passes = binning["passes"]
    want = {"select_values": 3 * passes, "select_counts": 2 * passes}
    if {k: launches.get(k) for k in want} != want:
        fail(f"bin_probe launched {launches}, want {want} in {passes} passes")
    for name in ("reduce_probe_shuffle", "reduce_probe_mma"):
        if launches.get(name, 0) < 1:
            fail(f"reduce_probe did not launch {name}: {launches}")
    emit({"phase": "probe", "seconds": time.perf_counter() - t0, "launches": launches,
          "launches_per_pass": {k: v // passes for k, v in want.items()},
          "level_ms": binning["ms"], "bin_probe": binning, "reduce_probe": reduction})
    return launches


class Stopwatch:
    """Host seconds spent inside chosen functions, each call bracketed by a
    device synchronize: where a command-line run's time goes."""

    def __init__(self):
        self.seconds: dict[str, list[float]] = {}

    def watch(self, owner, name: str, label: str):
        orig = getattr(owner, name)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                self.seconds.setdefault(label, []).append(time.perf_counter() - t0)

        return mock.patch.object(owner, name, timed)


def write_colmap_scene(root: Path, cams, points: np.ndarray, colors: np.ndarray) -> None:
    """A COLMAP dataset from posed views with images and a point cloud,
    through the port's own writers."""
    sparse = root / "sparse" / "0"
    (root / "images").mkdir(parents=True)
    sparse.mkdir(parents=True)
    cam0 = cams[0]
    intr = {1: colmap.ColmapCamera(1, "PINHOLE", cam0.width, cam0.height, np.array([
        fov2focal(cam0.fovx, cam0.width), fov2focal(cam0.fovy, cam0.height),
        cam0.width / 2.0, cam0.height / 2.0]))}
    images = {}
    for i, cam in enumerate(cams):
        name = f"{i:03d}.png"
        save_img_u8(cam.image.transpose(1, 2, 0), str(root / "images" / name))
        images[i + 1] = colmap.ColmapImage(
            i + 1, colmap.rotmat2qvec(cam.R.T), np.asarray(cam.T, np.float64), 1, name,
            np.zeros((0, 2)), np.zeros((0,), np.int64))
    colmap.write_cameras_binary(intr, str(sparse / "cameras.bin"))
    colmap.write_images_binary(images, str(sparse / "images.bin"))
    colmap.write_points3d_binary(points.astype(np.float64),
                                 np.clip(colors * 255.0, 0, 255).astype(np.uint8),
                                 str(sparse / "points3D.bin"))


def read_jsonl(path: Path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def cli(out_dir: Path):
    """The command-line main path at full width: a COLMAP dataset of the
    shell training set on disk, cli.train from a fresh start (spherical
    harmonics degree 0, as every run starts, ground truth over its device
    budget), a resume from its checkpoint stamped with step 3000 (degree 3,
    distortion loss on), cli.render and cli.metrics."""
    scene_dir, model_dir = out_dir / "scene", out_dir / "model"
    for d in (scene_dir, model_dir):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    cams, start = synthetic.make_shell_training_set(W, H, N_SPLATS, views=CLI_VIEWS, **GT_CAPS)
    points = start.xyz.detach().cpu().numpy()
    colors = sh_to_rgb(start.features_dc.detach()[:, 0]).cpu().numpy()
    del start
    write_colmap_scene(scene_dir, cams, points, colors)
    write_s = time.perf_counter() - t0

    caps = ["--bin_capacity", str(CAPS["bin_capacity"]), "--tile_capacity",
            str(CAPS["tile_capacity"]), "--col_capacity", str(CAPS["col_capacity"])]
    common = ["-s", str(scene_dir), "-m", str(model_dir), "--eval", "--resolution", "1",
              "--quiet", "--disable_viewer", "--lambda_dist", "100", *caps]
    watch = Stopwatch()
    launches = Counter()  # of the three runs below, each counted from zero
    first, ckpt_at = CLI_STEPS
    n_train, n_test = CLI_VIEWS - 1, 1  # every 8th view, from view 0, is held out
    report_views = n_test + 5           # the test set and 5 train views

    # -- a fresh run, ground truth over the device budget ---------------------
    native.LAUNCHES.clear()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for owner, name, label in (
                (Scene, "load", "scene_load"), (Scene, "save_model_info", "save_model_info"),
                (native_knn, "knn_mean_dist2", "knn_init"),
                (splats_lib, "create_from_pcd", "create_from_pcd"),
                (loop.Trainer, "train", "train_block"), (splats_lib, "save_ply", "save_ply"),
                (checkpoint, "save_checkpoint", "save_checkpoint")):
            stack.enter_context(watch.watch(owner, name, label))
        trainer = cli_train.main(
            [*common, "--iterations", str(first), "--save_iterations", str(first),
             "--test_iterations", str(first), "--checkpoint_iterations", str(ckpt_at),
             "--gt_cache_mb", "10"])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got = dict(native.LAUNCHES)
    launches.update(got)
    want = {"select_values": 3 * (first + report_views), "blend_tiles": first + report_views,
            "blend_tiles_backward": first}
    if got != want:
        fail(f"cli.train: {first} steps and {report_views} report views launched {got}, "
             f"want {want}")
    if trainer.gt_prestaged or trainer.active_sh_degree != 0 or trainer.step != first:
        fail("cli.train: the fresh run should keep its ground truth on the host, train at "
             f"degree 0 and stop at {first}: prestaged {trainer.gt_prestaged}, degree "
             f"{trainer.active_sh_degree}, step {trainer.step}")
    if len(trainer.cameras) != n_train or int(trainer.model.num_live()) != N_SPLATS:
        fail(f"cli.train: {len(trainer.cameras)} train views, "
             f"{int(trainer.model.num_live())} live splats")

    # -- the checkpoint, stamped with step 3000, resumed at full width ----------
    model, adam, step, _ = checkpoint.load_checkpoint(str(model_dir / f"chkpnt{ckpt_at}.npz"))
    if step != ckpt_at or adam.count != ckpt_at:
        fail(f"checkpoint holds step {step}, Adam count {adam.count}, want {ckpt_at}")
    resume_from = model_dir / "chkpnt3000.npz"
    checkpoint.save_checkpoint(str(resume_from), model, adam, 3000)
    del model, adam
    last = 3000 + CLI_RESUME_STEPS
    native.LAUNCHES.clear()
    t0 = time.perf_counter()
    with watch.watch(loop.Trainer, "train", "train_block_resumed"):
        resumed = cli_train.main(
            [*common, "--start_checkpoint", str(resume_from), "--iterations", str(last),
             "--save_iterations", str(last), "--test_iterations", str(last)])
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    got = dict(native.LAUNCHES)
    launches.update(got)
    want = {"select_values": 3 * (CLI_RESUME_STEPS + report_views),
            "blend_tiles": CLI_RESUME_STEPS + report_views,
            "blend_tiles_backward": CLI_RESUME_STEPS}
    if got != want:
        fail(f"cli.train resumed: launched {got}, want {want}")
    if (resumed.step, resumed.adam.count, resumed.active_sh_degree, resumed.gt_prestaged) \
            != (last, ckpt_at + CLI_RESUME_STEPS, 3, True):
        fail(f"cli.train resumed: step {resumed.step}, Adam count {resumed.adam.count}, "
             f"degree {resumed.active_sh_degree}, prestaged {resumed.gt_prestaged}")

    log = read_jsonl(model_dir / "metrics.jsonl")
    l1 = [(d["step"], d["train_loss_patches/l1_loss"]) for d in log
          if "train_loss_patches/l1_loss" in d]
    total = [d["train_loss_patches/total_loss"] for d in log
             if "train_loss_patches/total_loss" in d]
    if len(l1) < 2 or not all(math.isfinite(v) for _, v in l1) \
            or not all(math.isfinite(v) for v in total):
        fail(f"cli.train: logged losses {l1}, {total}")
    if not l1[-1][1] <= l1[0][1]:
        fail(f"cli.train: the logged L1 loss rose from {l1[0]} to {l1[-1]}")

    ply = model_dir / "point_cloud" / f"iteration_{last}" / "point_cloud.ply"
    t0 = time.perf_counter()
    reloaded = splats_lib.load_ply(str(ply))
    torch.cuda.synchronize()
    load_ply_s = time.perf_counter() - t0
    if int(reloaded.num_live()) != int(resumed.model.num_live()):
        fail(f"saved PLY reloads with {int(reloaded.num_live())} live splats, the trainer "
             f"had {int(resumed.model.num_live())}")

    # -- render and metrics ---------------------------------------------------------
    native.LAUNCHES.clear()
    t0 = time.perf_counter()
    with watch.watch(Scene, "load", "render_scene_load"), \
            watch.watch(splats_lib, "load_ply", "render_load_ply"):
        cli_render.main(["-m", str(model_dir), "--skip_mesh", "--quiet", *caps])
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    got = dict(native.LAUNCHES)
    launches.update(got)
    if got != {"select_values": 3 * CLI_VIEWS, "blend_tiles": CLI_VIEWS}:
        fail(f"cli.render: {CLI_VIEWS} views launched {got}")

    from PIL import Image

    test_dir = model_dir / "test" / f"ours_{last}"
    with Image.open(test_dir / "renders" / "00000.png") as im:
        png = np.asarray(im, np.float32) / 255.0
    with Image.open(test_dir / "vis" / "depth_00000.tiff") as im:
        depth = np.asarray(im)
    p = reloaded.params
    # the held-out view as cli.render read it from the dataset
    held_out = Scene.load(str(scene_dir), resolution=1, eval_split=True,
                          shuffle=False).test_cameras[0]
    settings = api.RasterSettings(W, H, **{k: v for k, v in CAPS.items()
                                           if k != "grad_pack_capacity"})
    with torch.no_grad():
        ref = api.render(held_out.arrays(), settings, p.xyz, torch.exp(p.scaling), p.rotation,
                         torch.sigmoid(p.opacity[:, 0]), splats_lib.features(p),
                         torch.zeros(3, device=p.xyz.device), live=reloaded.live)
    want_png = np.clip(ref["render"].cpu().numpy().transpose(1, 2, 0), 0, 1)
    # The PNG holds the render cut to 8 bits: within one step of them.
    png_err = float(np.abs(png - want_png).max())
    depth_err = float(np.abs(depth - ref["surf_depth"][0].cpu().numpy()).max())
    if png.shape != (H, W, 3) or png_err > 1.0 / 255.0 + RENDER_TOL or depth_err > RENDER_TOL:
        fail(f"cli.render view 0 against api.render of the reloaded PLY: image max|d| "
             f"{png_err} (one 8-bit step + {RENDER_TOL} allowed), depth max|d| {depth_err} "
             f"(tol {RENDER_TOL})")

    t0 = time.perf_counter()
    cli_metrics.main(["-m", str(model_dir), "--no_lpips"])
    metrics_s = time.perf_counter() - t0
    with open(model_dir / "results.json") as f:
        results = json.load(f)[f"ours_{last}"]
    if not (math.isfinite(results["PSNR"]) and math.isfinite(results["SSIM"])
            and results["LPIPS"] is None):
        fail(f"cli.metrics: {results}")
    for name in ("cfg_args", "cameras.json", "input.ply", "per_view.json"):
        if not (model_dir / name).exists():
            fail(f"the model directory lacks {name}")

    steps_ms = [1e3 * s / n for s, n in ((sum(watch.seconds["train_block"]), first),
                                         (sum(watch.seconds["train_block_resumed"]),
                                          CLI_RESUME_STEPS))]
    emit({"phase": "cli", "views": CLI_VIEWS, "train_views": n_train, "points": N_SPLATS,
          "seconds": {"write_dataset": write_s, "first_run": first_s, "resumed_run": resume_s,
                      "render": render_s, "metrics": metrics_s, "load_ply": load_ply_s,
                      **{k: sum(v) for k, v in watch.seconds.items()}},
          "step_ms_fresh_host_gt": steps_ms[0], "step_ms_resumed_sh3": steps_ms[1],
          "render_ms_per_view": 1e3 * (render_s - sum(watch.seconds["render_scene_load"])
                                       - sum(watch.seconds["render_load_ply"])) / CLI_VIEWS,
          "logged_l1": l1, "logged_total": total, "results": results,
          "png_max_abs_err": png_err, "depth_max_abs_err": depth_err,
          "num_live": int(reloaded.num_live())})
    shutil.rmtree(scene_dir)
    shutil.rmtree(model_dir)
    return launches


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
    outs, view_ms, per_view, blends = [], [], [], []
    for cam in cams:
        t0 = time.perf_counter()
        with record_calls(cuda_backend, "blend_tiles", blends):
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
          "cull_pass_share": [cull_shares(*args) for args, _ in blends],
          "alpha_mean": [float(o["rend_alpha"].mean()) for o in outs],
          "overflow": [{k: float(o[k]) for k in OVERFLOW} for o in outs]})
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = card()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    shutil.rmtree(native.BUILD, ignore_errors=True)  # time a cold build
    native.build_all()
    t_knn = time.perf_counter()
    native_knn.build_library()  # g++, the host's Morton KNN
    knn_build_s = time.perf_counter() - t_knn
    # ptxas -v lines of each kernel: registers, shared memory, spills
    ptxas = {n: [line.split(":", 1)[-1].strip() for line in
                 native.library_path(n).with_suffix(".log").read_text().splitlines()
                 if "registers" in line or "spill" in line] for n in native.SOURCES}
    occupancy = cuda_backend.blend_occupancy(torch.device("cuda"))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "knn_build_seconds": knn_build_s,
          "libraries": [native.library_path(n).name for n in native.SOURCES],
          "ptxas": ptxas, "blend_occupancy": occupancy})

    settings = api.RasterSettings(W, H, **CAPS)
    bench, selects, (rec3, counts, nty) = bench_inputs(settings)
    levels, level_counts = zip(*(select_level(lv, k)
                                 for lv, (_, k) in zip(("L1", "L2", "L3"), selects)))
    count_levels = [count_level(lv, selects[i][1], level_counts[i])
                    for i, lv in ((1, "L2"), (2, "L3"))]
    reduce_infos = reduce_check()
    blend = blend_check(rec3, counts, nty)
    bwd = backward_check(rec3, counts, nty)
    if sys.argv[1:] == ["kernels"]:
        return  # `python3 chip_smoke.py kernels`: build and kernel checks only, no verdict

    t0 = time.perf_counter()
    probe_launches = probes()
    probe_s = time.perf_counter() - t0

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
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli_launches = cli(out_dir)
    emit({"phase": "seconds", "probe": probe_s, "serve": serve_s, "train": train_s,
          "cli": time.perf_counter() - t0, "total": time.perf_counter() - t_start})

    def launched(name):
        return (probe_launches.get(name, 0) + launches.get(name, 0)
                + train_launches.get(name, 0) + cli_launches.get(name, 0))

    emit({"kernels": [
        {"name": "select_values", "route": "cuda",
         "source": "tpu2dgs_torch/csrc/select_values.cu",
         "replaces": "tpu2dgs/raster/select_kernel.py:126",
         "tpu_kernel": "tpu2dgs/raster/select_kernel.py:_select_values_kernel",
         "launches": launched("select_values"),
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
         "launches": launched("blend_tiles"),
         "max_abs_err": blend["max_abs_err"],
         "ms": blend["ms"], "plain_ms": blend["plain_ms"],
         "bound_ms": blend["bound_ms"], "bound_by": blend["bound_by"],
         "library_ms": None, "bound_all_pairs_ms": blend["bound_all_pairs_ms"],
         "cull_pass_share": blend["cull_pass_share"],
         "cull_warp_pass_share": blend["cull_warp_pass_share"],
         "longest_tile_ms": blend["longest_tile_ms"],
         "occupancy": occupancy["blend_tiles"], "ptxas": ptxas["blend_forward"]},
        {"name": "blend_tiles_backward", "route": "cuda",
         "source": "tpu2dgs_torch/csrc/blend_backward.cu",
         "replaces": "tpu2dgs/raster/pallas_backend.py:328",
         "tpu_kernel": "tpu2dgs/raster/pallas_backend.py:_bwd_kernel",
         "launches": launched("blend_tiles_backward"),
         "max_abs_err": bwd["max_abs_err"],
         "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
         "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
         "library_ms": None, "bound_all_pairs_ms": bwd["bound_all_pairs_ms"],
         "longest_tile_ms": bwd["longest_tile_ms"],
         "occupancy": occupancy["blend_tiles_backward"], "ptxas": ptxas["blend_backward"]},
        {"name": "select_counts", "route": "cuda",
         "source": "tpu2dgs_torch/csrc/select_counts.cu",
         "replaces": "tpu2dgs/raster/select_kernel.py:407",
         "tpu_kernel": "tpu2dgs/raster/select_kernel.py:_count_kernel",
         "launches": launched("select_counts"),
         "max_abs_err": 0.0,
         "ms": sum(lv["ms"] for lv in count_levels),
         "plain_ms": sum(lv["plain_ms"] for lv in count_levels),
         "bound_ms": sum(lv["bound_ms"] for lv in count_levels),
         "bound_by": "bytes" if all(lv["bound_by"] == "bytes" for lv in count_levels)
         else "operations",
         "library_ms": None,
         "levels": count_levels},
        *({"name": name, "route": "cuda",
           "source": "tpu2dgs_torch/csrc/reduce_probe.cu",
           "replaces": f"scripts/reduce_probe.py:{line}",
           "tpu_kernel": f"scripts/reduce_probe.py:{tpu}",
           "launches": launched(name),
           "max_abs_err": reduce_infos[name]["max_abs_err"],
           "max_rel_err": reduce_infos[name]["max_rel_err"],
           "ms": reduce_infos[name]["ms"], "plain_ms": reduce_infos[name]["plain_ms"],
           "bound_ms": reduce_infos[name]["bound_ms"],
           "bound_by": reduce_infos[name]["bound_by"],
           # no one PyTorch call computes it: planes_sum_ms (kernels phase) times
           # only the row sums of planes that already exist in device memory
           "library_ms": None}
          for name, line, tpu in (("reduce_probe_shuffle", 44, "kernel_vpu"),
                                  ("reduce_probe_mma", 56, "kernel_mxu"))),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
