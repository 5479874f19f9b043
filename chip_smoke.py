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
           gradient through the plain versions. Then a Trainer with
           camera_batch 4 takes 6 steps of all four views at once (K1 12
           / K2 4 / K3 4 launches a step), and one batched step's loss and
           gradient are held against the mean of the four views'.
  rows     tile rows over ranks on the shell: the blend kernels at a
           tile-row offset (rank 1's strip of a two-way split) against
           their plain versions; strips and work windows for 2, 4 and 8
           ranks rendered one by one and stitched against the full frame
           (lists and pixels); two ranks sharing the card over gloo
           through render(mesh=) and Trainer(mesh=), against one rank, K1
           3 / K2 1 / K3 1 launches per rank and step. Two ranks on one
           card check results; they measure no scaling.
  splats   splat sharding on the shell, two ranks sharing the card over
           gloo, each holding half of the splats: render(mesh=,
           shard_splats=True) and its gradients for static strips and work
           windows with the all-gather and the routed exchange against one
           rank's render, a routed render whose messages overflow (its
           counter against the demand counted from the boxes), and
           Trainer(mesh=, shard_splats=True) steps through a densification
           round (held against densify_and_prune(segments=2) of the
           gathered state) and a segmented growth; K1 3 / K2 1 / K3 1
           launches per rank and render or step, each rank at half the
           capacity; each rank's peak device memory over 3 steps against
           one rank's, run in a process of its own. It measures no scaling.
  ranks    the viewer over ranks and the collective probe: two ranks sharing
           the card over gloo run Trainer(mesh=, gui=) on the shell
           training set under tile rows and under splat sharding, rank 0
           serving a client thread that pauses training, asks for a frame
           in each render mode and one without a camera, holds the pause
           past two heartbeats and resumes; every frame's bytes equal to
           the one-device frame of the same state, K1 3 / K2 1 a frame on
           each rank that renders it (rank 0 alone under tile rows), K1 3 /
           K2 1 / K3 1 a step; cli.train --n_devices 2 with the viewer on
           and no client against --disable_viewer (losses within the card's
           run-to-run spread, step ms);
           eval.collective_probe on 8 ranks sharing the card at the JAX
           script's defaults (2^14 splats, 256x256) and at the bench shape
           (2^17, 800x800): bytes by kind and part a setting, K1 3 / K2 1 /
           K3 1 a rank and setting. It measures no scaling.
  cli      the shell training set written to disk as a COLMAP dataset,
           cli.train from a fresh start with its ground truth kept on the
           host, a resume from its checkpoint at full width, cli.render at
           capacities where no counter fires and at cli.train's default
           capacity flags, which heal (the same PNGs and depth TIFFs byte
           for byte, K1 3 / K2 1 launches a render, re-renders included),
           cli.metrics on the model directory, and eval.summary on the
           directory that holds it (its row holds cli.metrics' PSNR and
           SSIM).
  mesh     inside cli, on the model it trained: cli.render without
           --skip_mesh at the default capacity flags, which heal, a
           bounded TSDF at the default --mesh_res 1024 from median depth
           (--depth_ratio 1) and a contracted one from mean depth
           (--unbounded --mesh_res 512 --cull_views 1); the four mesh PLYs
           read back, and the bounded mesh held against the shell it was
           trained to show.
  viewer   inside cli, on the model it trained: cli.view's request
           (NetworkGUI.serve of ModelView.render) answers a remote viewer
           on loopback (a client thread of this process): each of the six
           render modes 3 times, a message without a camera (no image), 24
           RGB frames around the orbit, at the default capacity flags,
           which heal; every frame's bytes equal to the render of its
           camera at the capacities ModelView ended at, put through its
           mode and cut to bytes directly on the card, K1 3 / K2 1
           launches a render; host ms a frame from request to reply.
           Trainer(gui=) on the shell training set for 40 steps with a
           client asking for frames, pausing training (the step must hold
           still) and resuming it: K1 3 / K2 1 / K3 1 launches a step and
           K1 3 / K2 1 a frame. LPIPS on random weights (seed 0; its values
           mean nothing against published LPIPS): the card against the
           CPU at 256x256, an 800x800 pair timed, and cli.metrics with its
           LPIPS column on the model.
  backends the cuda, tiled and oracle backends on one 800x800 shell view at
           capacities no list overflows, the first two held against the
           oracle, all three against the oracle run in float64; the
           training loss's gradient through the kernels against the
           float64 oracle's on a 256x256 bench scene; the tiled backend's
           served-view and training-step times beside the cuda backend's;
           select_rows against its plain version.
  quality_gate  eval.quality_gate at its defaults (2000 iterations at
           128x128 through cli.train, cli.render with the mesh from the
           training flags, healing, and cli.metrics): K1 3 / K2 1 / K3 1
           launches per step, and the gate's verdict, which must pass.
  scripts  the JAX repo's scripts as the port's entry points, each called
           as a function: eval.train_bench at its defaults (the Trainer's
           capacities settled, then 300 timed steps at 800x800 with 2^17
           splats, no growth inside them), eval.soak_train at 800x800 cut
           to SOAK_STEPS steps (PSNR over 4 views must rise, every
           parameter and moment finite), K1 3 / K2 1 / K3 1 launches a step
           and K1 3 / K2 1 a render in both, every loss finite;
           eval.fidelity_probe (the exact render overflows nowhere; the
           demand and truncation rows of both scenes); eval.capk_probe (K2
           and K3 timed at 1024, 2048 and 4096, and 4096 at 2048's counts
           bit-equal to 2048; at 4096 both finite and within their
           standing tolerances of their plain versions);
           eval.loss_probe's four chains; eval.strip_balance_probe's
           max/mean work at 2, 4 and 8 devices on both scenes.

Each path counts the kernel launches it makes, from zero. Each phase
prints one JSON line; the line before the last but one lists every kernel
with its launches, times and bound, and the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed check exits nonzero before that line. Needs a CUDA device, nvcc
and g++; imports nothing of JAX. `python3 chip_smoke.py kernels` stops
after the kernel checks, and `python3 chip_smoke.py rows` runs the build
and the rows phase alone, `python3 chip_smoke.py splats` the build and the
splats phase alone, `python3 chip_smoke.py ranks` the build and the ranks
phase alone (`ranks_nccl` on a host with two GPUs: its viewer and cli runs on
cuda:0 and cuda:1 over NCCL), `python3 chip_smoke.py viewer` the build, the cli phase
without the mesh and the viewer phase, `python3 chip_smoke.py scripts` the
same and then the scripts phase, `python3 chip_smoke.py mesh_depth` the
build, the cli phase and its bounded mesh at mean and median depth over
whole and cut lists; none of them prints a verdict.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import os
import re
import resource
import select
import shutil
import subprocess
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
from tpu2dgs_torch.cli import view as cli_view
from tpu2dgs_torch.core.cameras import fov2focal
from tpu2dgs_torch.core.sh import sh_to_rgb
from tpu2dgs_torch.data import colmap
from tpu2dgs_torch.data.paths import save_img_u8
from tpu2dgs_torch.data.scene import Scene
from tpu2dgs_torch.eval import (bin_probe, capk_probe, collective_probe, fidelity_probe,
                                geometry, loss_probe, lpips, quality_gate, reduce_probe,
                                soak_train, strip_balance_probe, summary, synthetic, train_bench)
from tpu2dgs_torch.eval.timing import Stopwatch, card, cuda_ms
from tpu2dgs_torch.mesh import cull, extract, marching, tsdf
from tpu2dgs_torch.model import optim as optim_lib
from tpu2dgs_torch.model import splats as splats_lib
from tpu2dgs_torch.native import build as native
from tpu2dgs_torch.native import knn as native_knn
from tpu2dgs_torch.parallel import distributed, rehearsal, sharded
from tpu2dgs_torch.raster import (api, binning, capacity, cuda_backend, preprocess,
                                  select_kernel)
from tpu2dgs_torch.train import checkpoint, loop
from tpu2dgs_torch.viewer import modes as viewer_modes
from tpu2dgs_torch.viewer import network_gui

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
# The rows phase: strips and work windows for these device counts, and the
# two ranks that share the one card for render(mesh=) and ROWS_STEPS
# Trainer(mesh=) steps.
ROWS_SPLITS = (2, 4, 8)
ROWS_RANKS = 2
ROWS_STEPS = 4
# The splats phase: two ranks sharing the card, each holding half of the
# shell's 131,072 splats (k_loc 65,536 survivors a rank); a routed exchange
# at a cap small enough to overflow; SPLAT_STEPS Trainer steps with one
# densification round (after step 4) that grows the capacity.
SPLAT_RANKS = 2
SPLAT_XFER_SMALL = 4096
SPLAT_STEPS = 6
SPLAT_ROUTED_TOL = 1e-5  # routed renders against the all-gather ones, max |d|
# The ranks phase: Trainer(mesh=, gui=) on two ranks sharing the card, under
# tile rows and under splat sharding: RANKS_STEPS steps with the viewer on and
# no client, then one step whose poll serves a client that pauses training,
# asks for a frame in each render mode and one without a camera, holds the
# pause for RANKS_HOLD_S (RANKS_HEARTBEAT_S apart, rank 0 tells the other
# rank it is still paused) and resumes; cli.train --n_devices 2 for
# RANKS_CLI_STEPS steps with the viewer on and no client, against
# --disable_viewer, twice each in turns (off, on, off, on);
# eval.collective_probe on PROBE_RANKS ranks at the JAX script's defaults
# and at the bench shape.
RANKS = 2
RANKS_STEPS = 3
RANKS_HEARTBEAT_S = 1.0
RANKS_HOLD_S = 2.5
RANKS_CLI_STEPS = 12
RANKS_NCCL_CLI_STEPS = 48  # ranks_nccl's: a step there is about 30 ms
# Two runs of the same training differ on the card in the last bits (atomic
# float additions, `index_add_`'s among them, add in no fixed order): 1.2e-6
# relative at step 12 between two runs without the viewer on an NVIDIA H100
# 80GB HBM3, 700.00 W.
RANKS_CLI_LOSS_RTOL = 1e-4
PROBE_RANKS = 8
PROBE_SHAPES = ((14, 256), (17, 800))  # (N_log2, W)
TRAIN_STEPS = 24
TRAIN_VIEWS = 4  # one epoch of the camera shuffle: first and last 4 steps see every view
# The batched run: camera_batch = TRAIN_VIEWS, every view in each of BATCH_STEPS
# steps (no densification round among them); one batched step's loss against
# the mean of the views' losses, relative.
BATCH_STEPS = 6
BATCH_LOSS_RTOL = 1e-5
# The command-line phase: 4 views on disk (3 to train on, 1 held out), a
# fresh run of 12 iterations with a checkpoint at 10, a resumed run of 10.
CLI_VIEWS = 4
CLI_STEPS = (12, 10)
CLI_RESUME_STEPS = 10
# The mesh phase: the unbounded run at --mesh_res 512, cut from the default
# 1024 (the bounded run keeps it) to bound the phase's time; each PLY holds
# more faces than MESH_MIN_FACES; the post-processed bounded mesh lies within
# MESH_ACCURACY of the shell on average (the accuracy term of
# eval.geometry.chamfer_distance), the voxel size the JAX package's quality
# gate meshes at (scripts/quality_gate.py:180). Completeness and Chamfer are
# reported, not gated: three views on the equator see neither the caps nor
# the fourth quadrant. The bounded run meshes at median depth, the bounded
# recipe of the README's quick start and of eval/dtu_eval.py and
# eval/tnt_eval.py; the unbounded run at the default mean depth. Over whole
# lists the mean depth of a model this young (22 steps, opacities near
# create_from_pcd's 0.1) takes in the back of the shell
# (`python3 chip_smoke.py mesh_depth` measures both depths).
MESH_BOUNDED_FLAGS = ["--depth_ratio", "1"]
MESH_RES_UNBOUNDED = 512
MESH_MIN_FACES = 10_000
MESH_ACCURACY = 0.02
# The completeness query (shell -> mesh) dominates the check's time: the
# shell's unseen half lies far from every mesh sample, and a KD-tree search
# from far away visits much of the tree (2^21 shell points against 2^20
# samples: 151-153 s a run on the host of an NVIDIA H100 80GB HBM3, 700.00 W).
SHELL_POINTS = 1 << 20   # generating surface, from seed 0
MESH_SAMPLES = 1 << 18   # area-weighted samples of a mesh, from seed 0
# The viewer phase, on the command-line phase's model: cli.view's request
# (NetworkGUI.serve of ModelView.render) answers a loopback client that asks
# for each render mode MODE_FRAMES times, sends one message without a
# camera, then asks for ORBIT_FRAMES RGB frames around the orbit. Trainer(gui=) takes GUI_STEPS
# steps on the shell training set with a client that asks for frames,
# pauses training for PAUSE_S and resumes it. LPIPS runs on random weights
# (seed 0, as tests/test_lpips.py makes them): the card against the CPU at
# LPIPS_RES within LPIPS_TOL (relative), and an 800x800 pair timed.
MODE_FRAMES = 3
ORBIT_FRAMES = 24
GUI_STEPS = 40
PAUSE_S = 1.0
LPIPS_RES = 256
LPIPS_TOL = 1e-4
CLIENT_TIMEOUT_S = 120.0

# H100 SXM published peaks (NVIDIA data sheet): device memory rate and the
# float32 rate outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# One SM of the 132: the reduction probes run one block by design (the TPU
# probe's grid is (1,)), so their bound is one SM's: its share of the f32
# and dense bf16 tensor-core peaks.
SMS = 132
SM_F32_S = PEAK_F32_S / SMS
SM_BF16_S = 989e12 / SMS
# Operations per (candidate, row) of the select kernel's hit tests and per
# (record, pixel) of the blend, counted from the kernels' source.
BOX_TEST_OPS = 7
EXACT_TEST_OPS = 198
# The count kernel's issue-slot floor: an SM issues one warp-instruction a
# clock on each of its 4 schedulers (128 lanes a clock) at the H100 SXM's
# boost clock, whatever the instructions are; --fmad=false makes every
# multiply and add of the test its own instruction.
LANES_PER_SM = 128
SM_CLOCK_HZ = 1.98e9
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

# The backends phase holds the cuda and tiled backends to the oracle on one
# 800x800 shell view, at capacities with room for every list. A pixel of a
# map is past where a channel differs from the oracle's value v by more than
# the repo's render tolerance, RENDER_TOL (1 + |v|) (tests/test_pallas.py's
# assert_allclose). Of each gated map at most FLIP_SHARE of the pixels may
# be past: half a 16x16 sub-tile, K2's least unit of work (128 pixels), so
# a fault confined to one sub-tile's pixels shows. At every pixel, a map
# that sums T alpha c over the splats (render, rend_alpha, rend_normal) may
# differ by at most FLIP_CAP max |c|: both sides walk the splats in the
# same order (the same float32 depth keys), so a pixel moves only where a
# splat's contribution test decides otherwise (its alpha moves by at most
# opacity e^-4.5, the Gaussian at its 3-sigma edge; 1/255 is less), and
# the sum by at most T (|c_i| + max |c|) a splat. depth_accum is K2's
# depth channel before the division by alpha (depth_expected x
# rend_alpha); its c, the depth where the ray meets the splat's plane,
# grows without bound as a splat turns edge-on, so it is held by its share
# alone, as rend_dist (a sum over pairs) and depth_median (a selection)
# are. surf_depth and surf_normal, decoded from the depth and alpha maps by
# the same code on every backend, are reported. The three float32 renders
# are also held to the oracle run in float64, and reported: what float32
# costs the spec itself.
GATED_MAPS = ("render", "rend_alpha", "rend_normal", "rend_dist", "depth_accum",
              "depth_median")
FLIP_SHARE = 128 / (W * H)
FLIP_CAP = 2.0 * math.exp(-4.5)
LISTED_MAPS = (*GATED_MAPS, "surf_depth")  # each pixel past printed with alpha, T
# The gradient check: the loss's derivative with respect to these maps,
# taken at the float64 render, is sent back through each backend.
LOSS_MAPS = ("render", "rend_normal", "surf_normal", "rend_dist")
GRAD_SCENE = (256, 256, 8192)  # w, h, splats of the bench generator, seed 0
GRAD_SCENE_CAPS = dict(bin_capacity=8192, tile_capacity=8192, col_capacity=8192)
BACKEND_REPS = 3
# The quality gate at its calibrated defaults (iterations, pixels).
QGATE = (2000, 128)
# The scripts phase: the soak cut from the script's 3000 steps to SOAK_STEPS
# (densification rounds at steps 600-1100, until 0.8 of the steps) for the
# phase's time; its width, scene and schedule are the script's. Launches of
# a training step and of a render.
SOAK_STEPS = 1500
STEP_LAUNCHES = {"select_values": 3, "blend_tiles": 1, "blend_tiles_backward": 1}
VIEW_LAUNCHES = {"select_values": 3, "blend_tiles": 1}

KEYS = ["render", "rend_alpha", "rend_normal", "rend_dist", "surf_depth",
        "surf_normal", "depth_median"]
OVERFLOW = ["tile_overflow_frac", "bin_overflow_frac", "col_overflow_frac",
            "vis_overflow", "grad_pack_overflow_frac", "tile_count_max"]
FIRES = OVERFLOW[:5]  # the counters that say a list was cut


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
    return out, selects, blends[0][0][:3]  # (rec3, counts, nty); row0 is 0


def select_walk_m(kwargs) -> int:
    """Candidates per parent list as the kernel sees them: padded to whole
    macro blocks."""
    cand = kwargs["cand_channels"]
    m = (cand[0] if isinstance(cand, (tuple, list)) else cand).shape[-1]
    return -(-m // select_kernel.MACRO) * select_kernel.MACRO


def select_walk(kwargs):
    """What a select level's rows walk and what must be read for them:
    (walked candidates per row, candidates read per parent summed over the
    parents, tested channels, operations per test)."""
    m = select_walk_m(kwargs)
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


def select_level(level, kwargs):
    """Hold the select kernel against its plain version on one level, and
    two of its launches against each other."""
    got, cnt = select_kernel.select_values(**kwargs)
    again, again_cnt = select_kernel.select_values(**kwargs)
    ref, ref_cnt = select_kernel.select_values_plain(**kwargs)
    torch.cuda.synchronize()
    if not (bits_equal(got, ref) and torch.equal(cnt, ref_cnt)):
        diff = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        fail(f"select {level}: kernel differs from plain ({diff} values, "
             f"counts equal: {torch.equal(cnt, ref_cnt)})")
    if not (bits_equal(again, got) and torch.equal(again_cnt, cnt)):
        fail(f"select {level}: two launches on the same inputs differ")
    del again, ref
    ms = cuda_ms(lambda: select_kernel.select_values(**kwargs), reps=20)
    plain_ms = cuda_ms(lambda: select_kernel.select_values_plain(**kwargs),
                       reps=5, warmup=1)
    kernel_ms = bin_probe.alone_ms(select_kernel._launch, kwargs, kwargs["cap"])

    # Bound: the tested channels of every parent's walked candidates read
    # once, every output slot and count written once; hit tests of every
    # walked (row, candidate) pair.
    walked, read, n_test, test_ops = select_walk(kwargs)
    cap = kwargs["cap"]
    rows, n_chan = got.shape[0], got.shape[1]
    bytes_ = 4 * (read * n_test + rows * n_chan * cap + rows * 7)
    ops = int(walked.sum()) * test_ops
    bound_ms, bound_by = bound(bytes_, ops)
    # The grid the wrapper launched: (row, 1024-candidate chunk) items over
    # as many CTAs as the card holds at once.
    sms, per_sm = select_kernel.kernel_occupancy(got.device)
    plan = select_kernel.chunk_plan(rows, int(select_walk_m(kwargs)), sms, per_sm)
    info = dict(level=level, rows=rows, out_shape=list(got.shape), cap=cap,
                walked=int(walked.sum()), hits=int(cnt.sum()), max_count=int(cnt.max()),
                items=plan.items, ctas=plan.ctas, chunk=select_kernel.CHUNK, ctas_per_sm=per_sm,
                ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=0.0)
    emit({"phase": "kernels", "kernel": "select_values", **info})
    return info, cnt


def sass_item_instructions(source: str) -> dict[str, tuple[int, int]]:
    """(body, loop): static SASS instructions of each kernel's innermost
    loop that holds all its 128-bit loads, from the loop's top to the first
    barrier after those loads and to its end, by mangled name, from
    `cuobjdump -sass` of csrc/<source>'s built library (NOPs left out). For
    the count kernel the loop is its item loop: every warp runs the body,
    the test of its threads' 4 candidates each and their sums, once a
    walked item; warp 0 then runs the ticket tail in the rest."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(native.library_path(source))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    funcs, current = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)(.*)", line)
        if current is not None and m and m.group(2) != "NOP":
            current.append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = {}
    for name, ins in funcs.items():
        loads = [a for a, op, _ in ins if op.startswith("LDG.E.128")]
        if not loads:
            continue
        targets = [(int(t.group(1), 16), a) for a, op, rest in ins
                   if op == "BRA" and (t := re.match(r"\s+0x([0-9a-f]+)", rest))]
        loops = [(lo, hi) for lo, hi in targets if lo <= min(loads) and hi >= max(loads)]
        bars = [a for a, op, _ in ins if op.startswith("BAR") and a > max(loads)]
        if loops and bars:
            lo, hi = min(loops, key=lambda loop: loop[1] - loop[0])
            out[name] = (sum(1 for a, _, _ in ins if lo <= a <= min(bars)),
                         sum(1 for a, _, _ in ins if lo <= a <= hi))
    return out


def count_level(level, kwargs, k1_counts, sass):
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
    if any(bool(t.any()) for t in select_kernel._TICKETS.values()):
        fail(f"count {level}: a ticket is not back at zero")
    ms = cuda_ms(lambda: select_kernel.select_counts(**kwargs), reps=20)
    plain_ms = cuda_ms(lambda: select_kernel.select_counts_plain(**kwargs), reps=5, warmup=1)
    kernel_ms = bin_probe.alone_ms(select_kernel._count_launch, kwargs)

    # Bound: as the select kernel's, with one count written per row and no
    # output slots.
    walked, read, n_test, test_ops = select_walk(kwargs)
    rows = got.shape[0]
    bytes_ = 4 * (read * n_test + rows * 7)
    ops = int(walked.sum()) * test_ops
    bound_ms, bound_by = bound(bytes_, ops)
    # The grid the wrapper launched, and the issue-slot floor: every warp
    # runs the item loop's body of the kernel's instantiation for the
    # level's tests once a walked item, 4 candidates a thread, so the body's
    # SASS count over 4 is a test's instructions (warp 0's tail left out).
    sms, per_sm = select_kernel.count_occupancy(got.device)
    plan = select_kernel.count_plan(rows, select_walk_m(kwargs), sms, per_sm)
    tests = "ILb{:d}ELb{:d}E".format(kwargs.get("box_idx", (0, 1, 2, 3)) is not None,
                                     kwargs.get("exact_idx") is not None)
    loop = [n for name, n in sass.items() if f"select_counts_kernel{tests}" in name]
    if len(loop) != 1:
        fail(f"count {level}: no single item loop of select_counts_kernel{tests} in {sass}")
    per_test = loop[0][0] / 4
    floor_ms = int(walked.sum()) * per_test / (SMS * LANES_PER_SM * SM_CLOCK_HZ) * 1e3
    # Walked items a CTA takes in the launch's chunk-major order: the
    # longest CTA's against the mean.
    item_rows, item_chunks = (t.to(got.device) for t in select_kernel.count_items(plan))
    on_walk = item_chunks < walked[item_rows] // select_kernel.CHUNK
    per_cta = torch.zeros(plan.ctas, device=got.device).index_add_(
        0, torch.arange(plan.items, device=got.device) % plan.ctas, on_walk.float())
    info = dict(level=level, rows=rows, walked=int(walked.sum()), hits=int(got.sum()),
                items=plan.items, walked_items=int(walked.sum()) // select_kernel.CHUNK,
                ctas=plan.ctas, walked_items_per_cta_max=int(per_cta.max()),
                walked_items_per_cta_mean=float(per_cta.mean()),
                ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, item_body_instructions=loop[0][0],
                item_loop_instructions=loop[0][1],
                instructions_per_test=per_test, issue_floor_ms=floor_ms,
                l2_read_bytes=int(walked.sum()) * n_test * 4, device_read_bytes=bytes_,
                max_abs_err=0.0)
    emit({"phase": "kernels", "kernel": "select_counts", **info})
    return info


def ptxas_entries(source: str) -> dict[str, list[str]]:
    """ptxas -v lines (registers, shared memory, spills) of each kernel of
    csrc/<source>.cu, by its mangled entry name."""
    entries, current = {}, None
    for line in native.library_path(source).with_suffix(".log").read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            current = m.group(1)
        elif current and ("registers" in line or "spill" in line):
            entries.setdefault(current, []).append(line.split(":", 1)[-1].strip())
    return entries


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
    # Bounds on the one SM each kernel runs on. Shuffle: per step 16 planes
    # of 2048 values, each built (a multiply and an add) and summed (an
    # add), and 16 rows of 128 weighted and added, at one SM's f32 rate.
    # Tensor cores, the larger of two pipes' times: the selector products at
    # one SM's bf16 rate, one m16n8k16 product per part, 16-column x-block
    # and plane (3 x 8 x 16 = 384 a step, as the kernel shows enough), and
    # the plane values and their splits (4 f32 operations a value) at its
    # f32 rate.
    plane_values = reduce_probe.NPLANES * reduce_probe.BY * reduce_probe.BX
    ops = steps * (plane_values * 3 + reduce_probe.NPLANES * reduce_probe.BX * 2)
    products = steps * 3 * (reduce_probe.BX // 16) * reduce_probe.NPLANES
    mma_s = max(products * 2 * 16 * 8 * 16 / SM_BF16_S,
                steps * plane_values * 4 / SM_F32_S)
    bounds = {"reduce_probe_shuffle": (ops / SM_F32_S * 1e3, "operations"),
              "reduce_probe_mma": (mma_s * 1e3, "operations")}
    entries = ptxas_entries("reduce_probe")
    dynamic_smem = native.function("reduce_probe", "reduce_probe_dynamic_smem", [ctypes.c_int])
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
        ptxas = [line for entry, lines in entries.items() if f"{name}_kernel" in entry
                 for line in lines]
        spills = [line for line in ptxas if re.search(r"[1-9]\d* bytes spill", line)]
        if not ptxas or spills:
            fail(f"{name}: ptxas reports {ptxas or 'nothing'}")
        ms = cuda_ms(lambda: fn(base, steps), reps=20)
        infos[name] = dict(steps=steps, acc0=float(got[0]), plain_acc0=float(ref[0]),
                           max_rel_err=rel, max_abs_err=float((got - ref).abs().max()),
                           ms=ms, ns_per_set=ms * 1e6 / steps, plain_ms=plain_ms,
                           planes_sum_ms=planes_sum_ms, bound_ms=bounds[name][0],
                           bound_by=bounds[name][1], bound_scope="one SM",
                           dynamic_smem_bytes=dynamic_smem(int(name == "reduce_probe_mma")),
                           ptxas=ptxas)
        emit({"phase": "kernels", "kernel": name, **infos[name]})
    return infos


def pair_counts(rec3, counts, out, nty, row0=0) -> tuple[int, int]:
    """(hit pairs, blended pairs) of the lists: (record, pixel) pairs that
    pass the blend's hit test at or before their tile's last contributor,
    and of those the pairs that blended (at or before the pixel's own last
    contributor). All tiles in lockstep, the forward's hit test."""
    t = rec3.shape[0]
    px, py = cuda_backend._tile_planes(t, nty, rec3.device, row0)
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


def cull_share(rec3, counts, nty, rows=cuda_backend.BY, row0=0) -> float:
    """Share of the live (record, block) pairs that exact coverage keeps:
    with rows = 16 the blocks are the 16x16 sub-tiles, with rows = 4 the
    16x4 blocks of the warps, the cull the blend kernels run."""
    kept = int(cuda_backend.subtile_coverage(rec3, counts, nty, rows, row0).sum())
    blocks = cuda_backend.BX // cuda_backend.SUB * (cuda_backend.BY // rows)
    return kept / max(1, int(counts.to(torch.int64).sum()) * blocks)


def cull_shares(rec3, counts, nty, row0=0) -> dict:
    return {"cull_pass_share": cull_share(rec3, counts, nty, row0=row0),
            "cull_warp_pass_share": cull_share(rec3, counts, nty, rows=4, row0=row0)}


def longest_alone(counts, out):
    """The tile with the longest walk (out channel 12), and the counts and
    out that leave every other tile empty: a blend kernel given them times
    that tile alone."""
    last = out[:, 12].amax(dim=(1, 2))
    keep = torch.arange(counts.shape[0], device=counts.device) == int(torch.argmax(last))
    alone_out = out.clone()
    alone_out[:, 12] = torch.where(keep[:, None, None], out[:, 12], -1.0)
    return torch.where(keep, counts, 0).to(counts.dtype), alone_out


def blend_check(rec3, counts, nty, row0=0):
    """Hold the blend kernel against its plain version on the bench lists
    (of the strip from tile row `row0`)."""
    got = cuda_backend.blend_tiles(rec3, counts, nty, row0)
    ref = cuda_backend.blend_tiles_plain(rec3, counts, nty, row0)
    torch.cuda.synchronize()
    err = float((got[:, :12] - ref[:, :12]).abs().max())
    flips = float((got[:, 12] != ref[:, 12]).to(torch.float32).mean())
    if not (math.isfinite(err) and err <= KERNEL_TOL and flips <= LAST_FLIP_FRAC):
        fail(f"blend at row0 {row0}: kernel vs plain max|d| {err} (tol {KERNEL_TOL}), "
             f"last-contributor flips {flips} (tol {LAST_FLIP_FRAC})")
    ms = cuda_ms(lambda: cuda_backend.blend_tiles(rec3, counts, nty, row0), reps=20)
    # the plain version is timed on the full frame only (row0 = 0)
    plain_ms = None if row0 else cuda_ms(
        lambda: cuda_backend.blend_tiles_plain(rec3, counts, nty, row0), reps=2, warmup=1)
    alone_counts, _ = longest_alone(counts, ref)
    longest_ms = cuda_ms(lambda: cuda_backend.blend_tiles(rec3, alone_counts, nty, row0),
                         reps=20)

    # Bound: a pixel's records must be read up to its tile's last
    # contributor at least; 21 record floats each, read once, the output
    # written once; BLEND_OPS per hit pair, the pairs that must be blended
    # or killed. `bound_all_pairs_ms` counts every pair up to the tile's
    # last contributor, as a kernel without a cull computes them.
    t = rec3.shape[0]
    needed = (ref[:, 12].amax(dim=(1, 2)) + 1).clamp(min=0).to(torch.int64)
    pairs = int(needed.sum()) * cuda_backend.BY * cuda_backend.BX
    hits, blended = pair_counts(rec3, counts, ref, nty, row0)
    bytes_ = 4 * (int(needed.sum()) * 21 + t + got.numel())
    bound_ms, bound_by = bound(bytes_, hits * BLEND_OPS)
    info = dict(row0=row0, tiles=t, capk=rec3.shape[2], walked=int(counts.sum()),
                needed=int(needed.sum()), pairs=pairs, hit_pairs=hits, blended_pairs=blended,
                **cull_shares(rec3, counts, nty, row0), ms=ms, longest_tile_ms=longest_ms,
                plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                bound_all_pairs_ms=bound(bytes_, pairs * BLEND_OPS)[0],
                max_abs_err=err, last_flip_frac=flips)
    emit({"phase": "kernels" if row0 == 0 else "rows", "kernel": "blend_tiles", **info})
    return info


def backward_check(rec3, counts, nty, row0=0):
    """Hold the backward blend kernel against its plain version on the
    bench lists (of the strip from tile row `row0`), with room in the
    packed array and with too little."""
    dev = rec3.device
    t, _, capk = rec3.shape
    out = cuda_backend.blend_tiles(rec3, counts, nty, row0)
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
        args = (rec3, counts, off, out, dout, nty, pack_cap, row0)
        got = cuda_backend.blend_tiles_backward(*args)
        again = cuda_backend.blend_tiles_backward(*args)
        ref = cuda_backend.blend_tiles_backward_plain(*args)
        torch.cuda.synchronize()
        written = min(demand, pack_cap)
        g, a, r = got[:written], again[:written], ref[:written]
        if not bits_equal(g, a):
            fail(f"backward {name} at row0 {row0}: two launches on the same inputs differ")
        if not torch.equal(g[:, 19], r[:, 19]):
            fail(f"backward {name} at row0 {row0}: slot column differs from plain "
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
            fail(f"backward {name} at row0 {row0}: kernel vs plain row error {row_err} "
                 f"(tol {BWD_ROW_TOL}), "
                 f"scattered max|d| {err} against max|grad| {scale} (tol {BWD_SCATTER_TOL})")
        if float(gs[:, 19:].abs().max()) != 0.0:
            fail(f"backward {name} at row0 {row0}: record channels 19:24 received a gradient")
        info[name] = dict(pack_cap=pack_cap, written=written, row_rel_err=row_err,
                          max_abs_err=err, grad_max=scale, scatter_rerun_max_abs=rerun)
    if cases["overflow"] >= demand:
        fail("backward: the overflow case has room")

    args = (rec3, counts, off, out, dout, nty, cases["room"], row0)
    ms = cuda_ms(lambda: cuda_backend.blend_tiles_backward(*args), reps=20)
    got = cuda_backend.blend_tiles_backward(*args)
    scatter_ms = cuda_ms(lambda: cuda_backend.scatter_packed(got, eff, n_rec), reps=20)
    plain_ms = None if row0 else cuda_ms(
        lambda: cuda_backend.blend_tiles_backward_plain(*args), reps=1, warmup=0)
    alone_counts, alone_out = longest_alone(counts, out)
    alone_args = (rec3, alone_counts, off, alone_out, dout, nty, cases["room"], row0)
    longest_ms = cuda_ms(lambda: cuda_backend.blend_tiles_backward(*alone_args), reps=20)

    # Bound: the 22 read channels of every record up to its tile's last
    # contributor, the planes of out (3, 10, 11, 12) and dout (0-9) the walk
    # reads, each once, the reserved rows written once;
    # the response of every hit pair and the gradient arithmetic of the pairs
    # that blended. `bound_all_pairs_ms` takes the response of every pair up
    # to the tile's last contributor, as a kernel without a cull computes it.
    needed = (out[:, 12].amax(dim=(1, 2)) + 1).clamp(min=0).to(torch.int64)
    pairs = int(needed.sum()) * cuda_backend.BY * cuda_backend.BX
    hits, blended = pair_counts(rec3, counts, out, nty, row0)
    plane = cuda_backend.BY * cuda_backend.BX
    bytes_ = 4 * (int(needed.sum()) * 22 + 2 * t + t * plane * (4 + 10)
                  + demand * cuda_backend.OUTREC)
    bound_ms, bound_by = bound(bytes_, hits * BWD_RESPONSE_OPS + blended * BWD_BLENDED_OPS)
    info.update(row0=row0, tiles=t, capk=capk, group=grp, demand=demand, needed=int(needed.sum()),
                pairs=pairs, hit_pairs=hits, blended_pairs=blended, ms=ms,
                longest_tile_ms=longest_ms,
                scatter_ms=scatter_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bound_all_pairs_ms=bound(bytes_, pairs * BWD_RESPONSE_OPS
                                         + blended * BWD_BLENDED_OPS)[0],
                max_abs_err=info["room"]["max_abs_err"])
    emit({"phase": "kernels" if row0 == 0 else "rows", "kernel": "blend_tiles_backward",
          **info})
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
    batch = train_batch(caps)
    return {k: total.get(k, 0) + batch.get(k, 0) for k in {*total, *batch}}


def train_batch(caps):
    """The Trainer with camera_batch = TRAIN_VIEWS on the same shell
    training set: BATCH_STEPS steps of every view at once, no densification
    round among them, then one batched step on a private copy of the model
    against the mean of the views' losses and gradients through the
    kernels."""
    b = TRAIN_VIEWS
    cams, model = synthetic.make_shell_training_set(W, H, N_SPLATS, views=b, **GT_CAPS)
    cfg = loop.TrainConfig(
        normal_from_iter=0, dist_from_iter=0, lambda_dist=100.0,
        densify_from_iter=4, densification_interval=12, opacity_reset_interval=10_000,
        loss_sync_interval=12, camera_batch=b)
    events, launches, losses = [], [], []

    def log_fn(it, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        launches.append(dict(native.LAUNCHES))
        losses.append({k: metrics[k] for k in ("loss", "l1", "normal", "dist")})

    trainer = loop.Trainer(model, cams, W, H, spatial_lr_scale=1.0, scene_extent=1.0,
                           train_cfg=cfg, raster_kwargs=dict(caps, grad_pack_capacity=0),
                           log_fn=log_fn)
    trainer.active_sh_degree = 3

    native.LAUNCHES.clear()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    trainer.train(num_iters=BATCH_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    total = dict(native.LAUNCHES)

    names = ("select_values", "blend_tiles", "blend_tiles_backward")
    prev = dict.fromkeys(names, 0)
    for it, snap in enumerate(launches, 1):
        step = tuple(snap.get(k, 0) - prev[k] for k in names)
        if step != (3 * b, b, b):
            fail(f"batched train step {it} launched {dict(zip(names, step))}, "
                 f"want {3 * b} / {b} / {b}")
        prev = {k: snap.get(k, 0) for k in names}
    step_ms = [a.elapsed_time(e) for a, e in zip([start, *events], events)]

    loss = [{k: float(v) for k, v in d.items()} for d in losses]
    if not all(math.isfinite(v) for d in loss for v in d.values()):
        fail(f"batched train: non-finite loss {loss}")
    m, adam = trainer.model, trainer.adam
    for name, a in [*m.params._asdict().items(),
                    *((f"mu.{k}", v) for k, v in adam.mu._asdict().items()),
                    *((f"nu.{k}", v) for k, v in adam.nu._asdict().items())]:
        if not bool(torch.isfinite(a).all()):
            fail(f"batched train: non-finite {name}")
    if adam.count != BATCH_STEPS or trainer.last_densify is not None:
        fail(f"batched train: {adam.count} Adam steps, densify info {trainer.last_densify}")

    # One batched step on a private copy of the trained model from fresh
    # moments: its first moment is (1 - beta1) x the mean gradient over the
    # views, held against the mean of each view's gradients.
    settings = trainer._settings()
    views = [(trainer._cam_arrays[i], trainer._gt_images[i]) for i in range(b)]
    per_view = [loop.view_gradients(m, settings, cam, gt, trainer.bg, cfg.lambda_dssim,
                                    cfg.lambda_normal, cfg.lambda_dist)
                for cam, gt in views]
    copy = splats_lib.SplatModel(splats_lib.SplatParams(*(a.detach().clone() for a in m.params)),
                                 m.live.clone(), *(getattr(m, k).clone() for k in splats_lib.STATS))
    fresh = optim_lib.init_adam(copy.params)
    _, fresh, metrics = loop.train_step(
        settings, trainer.opt_cfg, cfg.lambda_dssim, 1.0, copy, fresh,
        [cam for cam, _ in views], [gt for _, gt in views], trainer.bg, 1.0,
        cfg.lambda_normal, cfg.lambda_dist)
    torch.cuda.synchronize()
    want_loss = float(torch.stack([v[0] for v in per_view]).mean())
    loss_rel = abs(float(metrics["loss"]) - want_loss) / abs(want_loss)
    if not loss_rel <= BATCH_LOSS_RTOL:
        fail(f"batched train: step loss {float(metrics['loss'])} against the views' mean "
             f"{want_loss} (relative {loss_rel}, tol {BATCH_LOSS_RTOL})")
    b1 = trainer.opt_cfg.beta1
    grad_err = {}
    for name, mu, *gs in zip(fresh.mu._fields, fresh.mu, *(v[2] for v in per_view)):
        g = torch.where(m.live.reshape((-1,) + (1,) * (mu.dim() - 1)),
                        torch.stack(gs).mean(dim=0), 0.0)
        scale = float(g.abs().max())
        grad_err[name] = {"max_abs_err": float((mu / (1 - b1) - g).abs().max()),
                          "grad_max": scale}
    bad = {k: v for k, v in grad_err.items()
           if not (math.isfinite(v["max_abs_err"]) and v["grad_max"] > 0.0
                   and v["max_abs_err"] <= GRAD_TOL * v["grad_max"])}
    if bad:
        fail(f"batched train: the step's gradient differs from the views' mean by more "
             f"than {GRAD_TOL} of max|grad|: {bad}; all: {grad_err}")

    steady = sorted(step_ms[1:])  # the first step warms up the allocator
    emit({"phase": "train", "camera_batch": b, "steps": BATCH_STEPS, "card": card(),
          "train_seconds": train_s, "pixels_per_step": b * W * H,
          "mpix_per_s": BATCH_STEPS * b * W * H / train_s / 1e6,
          "mpix_per_s_median_step": b * W * H / steady[len(steady) // 2] / 1e3,
          "step_ms_median": steady[len(steady) // 2], "step_ms_min": steady[0],
          "step_ms_max": steady[-1], "step_ms": step_ms, "launches": total,
          "loss": [d["loss"] for d in loss], "loss_vs_view_mean_rel": loss_rel,
          "grad_vs_view_mean": grad_err})
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


def mesh_quality(verts: np.ndarray, faces: np.ndarray, shell: np.ndarray) -> dict:
    """Accuracy (mesh -> shell), completeness (shell -> mesh) and Chamfer of
    a mesh against the generating shell."""
    pts = geometry.sample_mesh_points(verts, faces, MESH_SAMPLES, seed=0)
    acc, comp, chamfer = geometry.chamfer_distance(pts, shell)
    return {"accuracy": acc, "completeness": comp, "chamfer": chamfer}


def mesh(model_dir: Path, n_train: int, it: int):
    """The mesh main path on the command-line phase's model: cli.render
    without --skip_mesh at its default capacity flags, which heal, bounded
    at the default --mesh_res 1024 with MESH_BOUNDED_FLAGS, then unbounded
    at MESH_RES_UNBOUNDED with --cull_views 1. Each run renders the training views at SH degree
    0 and nothing else, K1 3 and K2 1 launches a render (a view, or a view
    rendered again at grown capacities). Returns the launches of both runs
    and their seconds."""
    out_dir = model_dir / "train" / f"ours_{it}"
    runs, launches = {}, Counter()
    t_phase = time.perf_counter()
    for name, extra, extract_fn, fuse in (
            ("bounded", MESH_BOUNDED_FLAGS, "extract_mesh_bounded", (tsdf, "integrate")),
            ("unbounded", ["--unbounded", "--mesh_res", str(MESH_RES_UNBOUNDED),
                           "--cull_views", "1"], "extract_mesh_unbounded",
             (extract, "_fuse_world_slab"))):
        watch, extractors, volumes, healers = Stopwatch(), [], [], []
        native.LAUNCHES.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            stack.enter_context(record_calls(extract.GaussianExtractor, "reconstruction",
                                             extractors))
            stack.enter_context(record_calls(tsdf, "make_volume", volumes))
            stack.enter_context(record_calls(capacity.CapacityHealer, "render", healers))
            for owner, fn, label in (
                    (extract.GaussianExtractor, "reconstruction", "reconstruction"),
                    (extract.GaussianExtractor, extract_fn, "extract"), (*fuse, "fusion"),
                    (marching, "marching_tetrahedra", "marching"), (cull, "cull_mesh", "cull"),
                    (extract, "post_process_mesh", "post_process"),
                    (extract, "write_mesh_ply", "write_ply")):
                stack.enter_context(watch.watch(owner, fn, label))
            caps = cli_render.main(["-m", str(model_dir), "--skip_train", "--skip_test",
                                    "--quiet", *extra])
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        got = dict(native.LAUNCHES)
        launches.update(got)
        healer = healers[0][0][0]
        want = {"select_values": 3 * healer.renders, "blend_tiles": healer.renders}
        if got != want or healer.views != n_train or healer.truncated:
            fail(f"mesh {name}: launched {got}, want {want} (the {n_train} training views "
                 f"and {healer.rerenders} re-renders, no backward); truncated "
                 f"{healer.truncated}")

        stem = "fuse" if name == "bounded" else "fuse_unbounded"
        counts = {}
        for suffix in ("", "_post"):
            path = out_dir / f"{stem}{suffix}.ply"
            if not path.exists():
                fail(f"mesh {name}: {path.name} was not written")
            verts, faces = extract.read_mesh_ply(str(path))
            if len(faces) <= MESH_MIN_FACES or not np.isfinite(verts).all() \
                    or faces.min() < 0 or faces.max() >= len(verts):
                fail(f"mesh {name}: {path.name} reads back with {len(verts)} vertices and "
                     f"{len(faces)} faces (more than {MESH_MIN_FACES} wanted, indices in range)")
            counts[f"{suffix.lstrip('_') or 'fused'}"] = {"vertices": len(verts),
                                                           "faces": len(faces)}

        # Fusion and marching run inside the extraction; the rest of it is
        # the grids' copies to the host, the unbounded grid's points and the
        # vertex colours.
        seconds = watch.totals()
        seconds["extract_rest"] = seconds["extract"] - seconds["fusion"] - seconds["marching"]
        seconds["other"] = total_s - sum(seconds.get(k, 0.0) for k in (
            "reconstruction", "extract", "cull", "post_process", "write_ply"))
        ex = extractors[0][0][0]
        voxels = (math.prod(volumes[0][0][1]) if name == "bounded"
                  else MESH_RES_UNBOUNDED ** 3)
        runs[name] = {"flags": extra, "seconds": seconds, "total_seconds": total_s,
                      "voxels": voxels,
                      "launches": got, "rerenders": healer.rerenders, "caps": caps,
                      "cap_events": healer.events, "peak_device_bytes": peak - base,
                      "peak_allocated_bytes": peak,
                      "host_maxrss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
                      "radius": ex.radius, "center": ex.center.tolist(), **counts}
        if name == "bounded":  # the post-processed mesh, against the shell
            t0 = time.perf_counter()
            quality = mesh_quality(verts, faces, synthetic.shell_surface_points(SHELL_POINTS,
                                                                                seed=0))
            runs[name].update(quality, voxel=volumes[0][0][2],
                              quality_seconds=time.perf_counter() - t0)
            if not quality["accuracy"] <= MESH_ACCURACY:
                fail(f"mesh bounded: accuracy {quality['accuracy']} against the shell, limit "
                     f"{MESH_ACCURACY}; run: {runs[name]}")
    emit({"phase": "mesh", "train_views": n_train, "mesh_res": {"bounded": 1024,
          "unbounded": MESH_RES_UNBOUNDED}, "shell_points": SHELL_POINTS,
          "mesh_samples": MESH_SAMPLES, "accuracy_limit": MESH_ACCURACY, "runs": runs})
    return launches, time.perf_counter() - t_phase


def mesh_depth(model_dir: Path, n_train: int, it: int):
    """`python3 chip_smoke.py mesh_depth`: what sets the bounded mesh's
    accuracy on the command-line phase's model. The bounded mesh at mean and
    at median depth (--depth_ratio 0 and 1), each at whole lists (the
    default flags, which heal) and at cut lists (the capacities the model
    trained at, healing off). For each: accuracy, completeness, Chamfer and
    faces of the post-processed mesh; the share of pixels with alpha > 0.5;
    the mean |depth difference| where alpha > 0.5 between mean and median
    depth and between whole and cut lists, and the share of those pixels
    whose mean depth lies more than MESH_ACCURACY behind the median. The
    model's opacities (sigmoid) at the 10th, 50th and 90th percentile."""
    ply = model_dir / "point_cloud" / f"iteration_{it}" / "point_cloud.ply"
    opacity = torch.sigmoid(splats_lib.load_ply(str(ply)).params.opacity[:, 0]).float().cpu()
    shell = synthetic.shell_surface_points(SHELL_POINTS, seed=0)
    post = model_dir / "train" / f"ours_{it}" / "fuse_post.ply"
    ways, maps = {}, {}
    for lists in ("whole", "cut"):
        for ratio in (0, 1):
            extractors = []
            with contextlib.ExitStack() as stack:
                stack.enter_context(record_calls(extract.GaussianExtractor, "reconstruction",
                                                 extractors))
                if lists == "cut":
                    stack.enter_context(mock.patch.object(capacity, "grow_caps",
                                                          lambda *a, **k: []))
                caps = cli_render.main(["-m", str(model_dir), "--skip_train", "--skip_test",
                                        "--quiet", "--depth_ratio", str(ratio)])
            ex = extractors[0][0][0]
            maps[lists, ratio] = (torch.stack([d[0] for d in ex.depthmaps]),
                                  torch.stack([a[0] for a in ex.alphamaps]))
            verts, faces = extract.read_mesh_ply(str(post))
            ways[f"{lists}_depth_ratio_{ratio}"] = {
                "caps": caps, "faces": len(faces), **mesh_quality(verts, faces, shell),
                "alpha_over_half": float((maps[lists, ratio][1] > 0.5).float().mean())}

    def gap(a, b) -> dict:
        mask = (maps[a][1] > 0.5) & (maps[b][1] > 0.5)
        d = (maps[a][0] - maps[b][0])[mask]
        return {"mean_abs": float(d.abs().mean()),
                "share_behind": float((d > MESH_ACCURACY).float().mean())}

    emit({"phase": "mesh_depth", "train_views": n_train, "ways": ways,
          "opacity_q10_q50_q90": torch.quantile(opacity, torch.tensor([0.1, 0.5, 0.9])).tolist(),
          "mean_against_median": {lists: gap((lists, 0), (lists, 1))
                                  for lists in ("whole", "cut")},
          "whole_against_cut": {f"depth_ratio_{r}": gap(("whole", r), ("cut", r))
                                for r in (0, 1)}})
    return Counter(), 0.0


def viewer_message(cam, mode: int = 0, train: bool = True) -> dict:
    """The control message a remote viewer sends for the host camera `cam`
    at 800x800."""
    return rehearsal.viewer_message(cam, W, H, mode, train)


def finish_client(client: rehearsal.ViewerClient, what: str) -> None:
    """Fail the phase unless the viewer client ended, unharmed, with a
    reply to each of its messages."""
    client.join(timeout=CLIENT_TIMEOUT_S)
    if client.is_alive() or client.error is not None:
        fail(f"{what}: the viewer client {'hangs' if client.is_alive() else client.error}")
    if len(client.replies) != len(client.messages):
        fail(f"{what}: {len(client.replies)} replies to {len(client.messages)} messages")


def accept_client(gui: network_gui.NetworkGUI) -> None:
    """Wait for the client on the listening socket, as cli.view does."""
    ready, _, _ = select.select([gui.listener], [], [], CLIENT_TIMEOUT_S)
    if ready:
        gui.try_connect()
    if gui.conn is None:
        fail("viewer: no client connected")


def spread(ms: list[float]) -> dict:
    return {"median": float(np.median(ms)), "max": float(max(ms)), "n": len(ms)}


def launches_since(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in native.LAUNCHES.items() if v != before.get(k, 0)}


def served_frames(model_dir: Path, it: int):
    """cli.view's request (NetworkGUI.serve of ModelView.render) on the
    model, at the default capacity flags, which heal: each mode MODE_FRAMES
    times from one pose, a message without a camera, ORBIT_FRAMES RGB
    frames around the orbit. Every frame's bytes must equal the render of
    the same camera, at the capacities ModelView ended at, put through the
    same mode and cut to bytes directly, and launch K1 3 and K2 1 times a
    render (a frame, or a frame rendered again at grown capacities).
    Returns (report, launches)."""
    view, _ = cli_view.open_model(["-m", str(model_dir), "--iteration", str(it)])
    items = network_gui.RENDER_ITEMS
    poses = [synthetic.shell_camera(2 * np.pi * (0.13 + k / ORBIT_FRAMES), W, H)
             for k in range(ORBIT_FRAMES)]
    asked = [(poses[0], mode) for mode in range(len(items)) for _ in range(MODE_FRAMES)]
    asked += [(None, 0), *((cam, 0) for cam in poses)]  # None: a message without a camera
    messages = [viewer_message(cam, mode) if cam is not None
                else {**viewer_message(poses[0]), "resolution_x": 0} for cam, mode in asked]

    gui = network_gui.NetworkGUI("127.0.0.1", 0)
    gui.init()
    cams, per_request, renders = [], [], []
    watch = Stopwatch()
    try:
        client = rehearsal.ViewerClient(gui.listener.getsockname()[1], messages,
                                        timeout_s=CLIENT_TIMEOUT_S)
        client.start()
        accept_client(gui)
        native.LAUNCHES.clear()
        with record_calls(cli_view.ModelView, "render", cams), \
                watch.watch(cli_view.ModelView, "render", "render"):
            for _ in messages:
                before, renders_before = dict(native.LAUNCHES), view.healer.renders
                gui.serve(view.render, view.verify, view.metrics)
                per_request.append(launches_since(before))
                renders.append(view.healer.renders - renders_before)
        launches = dict(native.LAUNCHES)
        finish_client(client, "cli.view")
    finally:
        gui.close()

    for (pose, _), got, n in zip(asked, per_request, renders):
        want = {"select_values": 3 * n, "blend_tiles": n} if n else {}
        if got != want or (n == 0) != (pose is None):
            fail(f"cli.view: a request launched {got} in {n} renders, want K1 3 and K2 1 a "
                 "render, and nothing for a message without a camera")
    if view.healer.truncated:
        fail(f"cli.view: frames truncated at the ceilings: {view.healer.truncated}")
    if client.items != items:
        fail(f"cli.view: render items {client.items}")

    # The same frames computed directly on the card, from the PLY read anew.
    ply = model_dir / "point_cloud" / f"iteration_{it}" / "point_cloud.ply"
    model = splats_lib.load_ply(str(ply))
    p = model.params
    args = (p.xyz, torch.exp(p.scaling), p.rotation, torch.sigmoid(p.opacity[:, 0]),
            splats_lib.features(p))
    bg = torch.zeros(3, device=p.xyz.device)
    served = iter(cams)
    cam_err = 0.0
    for k, ((pose, mode), (image, verify, metrics)) in enumerate(zip(asked, client.replies)):
        if verify != view.verify or metrics != {"#": int(model.num_live())}:
            fail(f"cli.view: reply {k} verify {verify!r}, metrics {metrics}")
        if pose is None:
            if image is not None:
                fail("cli.view: an image for a message without a camera")
            continue
        (_, cam, w, h, sm), _ = next(served)
        cam_err = max(cam_err, *(float((a - b).abs().max()) for a, b in zip(cam, pose.arrays())))
        settings = api.RasterSettings(width=w, height=h, scale_modifier=float(sm), **view.settings)
        with torch.no_grad():
            pkg = api.render(cam, settings, *args, bg, live=model.live)
        want_bytes = network_gui.image_to_bytes(viewer_modes.render_net_image(pkg, items, mode))
        if image != want_bytes:
            fail(f"cli.view: frame {k} ({items[mode]}) differs from the direct render -> mode "
                 "-> bytes")
    if cam_err > 1e-5:
        fail(f"cli.view: received cameras off the poses' by {cam_err}")

    n_modes = len(items) * MODE_FRAMES
    render_ms = [1e3 * s for s in watch.seconds["render"]]
    report = {
        "frames": len(cams), "launches": launches, "camera_max_abs_err": cam_err,
        "rerenders": view.healer.rerenders, "cap_events": view.healer.events,
        "caps": {k: view.settings[k] for k in capacity.RENDER_CAPS},
        "frame_ms_by_mode": {items[m]: spread(client.ms[m * MODE_FRAMES:(m + 1) * MODE_FRAMES])
                             for m in range(len(items))},
        "frame_ms_orbit_rgb": spread(client.ms[n_modes + 1:]),
        "no_camera_ms": client.ms[n_modes],
        "render_ms_by_mode": {items[m]: spread(render_ms[m * MODE_FRAMES:(m + 1) * MODE_FRAMES])
                              for m in range(len(items))},
        "render_ms_orbit_rgb": spread(render_ms[n_modes:]),
        "frame_bytes": W * H * 3}
    return report, launches


def gui_training():
    """Trainer(gui=) on the shell training set with a client connected:
    frames between steps, a pause that must hold the step still, a resume.
    Every step launches K1 3 / K2 1 / K3 1 times and every frame K1 3 / K2 1
    times. Returns (report, launches)."""
    cams, model = synthetic.make_shell_training_set(W, H, N_SPLATS, views=TRAIN_VIEWS, **GT_CAPS)
    raster_kwargs = dict({k: v for k, v in CAPS.items() if k != "grad_pack_capacity"},
                         grad_pack_capacity=0)
    gui = network_gui.NetworkGUI("127.0.0.1", 0)
    gui.init()
    trainer = loop.Trainer(model, cams, W, H, spatial_lr_scale=1.0, scene_extent=1.0,
                           raster_kwargs=raster_kwargs, gui=gui)
    trainer.source_path = "shell"
    # frames while training, a pause (a frame is still served while paused),
    # a resume, frames again
    trains = [True, True, False, False, True, True, True]
    messages = [viewer_message(cams[k % len(cams)], mode=k % 4, train=t)
                for k, t in enumerate(trains)]
    paused_at = trains.index(False) + 1  # message sent while the trainer waits
    held, served_at = [], []

    def before(i):
        served_at.append(trainer.step)
        if i == paused_at:
            s0 = trainer.step
            time.sleep(PAUSE_S)
            held.append((s0, trainer.step))

    steps, frames = [], []
    train_step, render_frame = loop.train_step, loop.Trainer._render_frame

    def counted_step(*args, **kwargs):
        before_ = dict(native.LAUNCHES)
        out = train_step(*args, **kwargs)
        steps.append(launches_since(before_))
        return out

    def counted_frame(*args, **kwargs):
        before_ = dict(native.LAUNCHES)
        out = render_frame(*args, **kwargs)
        torch.cuda.synchronize()
        frames.append(launches_since(before_))
        return out

    try:
        client = rehearsal.ViewerClient(gui.listener.getsockname()[1], messages, before,
                                        CLIENT_TIMEOUT_S)
        native.LAUNCHES.clear()
        client.start()
        t0 = time.perf_counter()
        with mock.patch.object(loop, "train_step", counted_step), \
                mock.patch.object(loop.Trainer, "_render_frame", counted_frame):
            trainer.train(num_iters=GUI_STEPS)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = dict(native.LAUNCHES)
    finally:
        gui.close()  # a client still waiting gets an error, not a hang
    finish_client(client, "Trainer(gui=)")

    step_want = {"select_values": 3, "blend_tiles": 1, "blend_tiles_backward": 1}
    frame_want = {"select_values": 3, "blend_tiles": 1}
    if len(steps) != GUI_STEPS or any(st != step_want for st in steps):
        fail(f"Trainer(gui=): {len(steps)} steps launched {steps}, want {step_want} each")
    if len(frames) != len(messages) or any(f != frame_want for f in frames):
        fail(f"Trainer(gui=): {len(frames)} frames launched {frames}, want {frame_want} each")
    total = {k: GUI_STEPS * step_want.get(k, 0) + len(frames) * frame_want.get(k, 0)
             for k in step_want}
    if launches != total:
        fail(f"Trainer(gui=): launched {launches}, want {total}")
    if not held or held[0][0] != held[0][1] or trainer.step != GUI_STEPS:
        fail(f"Trainer(gui=): the pause held the step at {held}, the run ended at {trainer.step}")
    if not 0 < served_at[-1] < GUI_STEPS:
        fail(f"Trainer(gui=): frames asked for at steps {served_at}, not while training")
    for image, verify, metrics in client.replies:
        if len(image) != W * H * 3 or verify != "shell" or metrics["#"] != N_SPLATS \
                or not (math.isfinite(metrics["loss"]) and metrics["loss"] > 0):
            fail(f"Trainer(gui=): a reply of {len(image)} bytes, {verify!r}, {metrics}")
    report = {"steps": GUI_STEPS, "frames": len(frames), "launches": launches,
              "train_seconds": train_s, "held_at_step": held[0][0], "pause_s": PAUSE_S,
              "frames_asked_at_steps": served_at, "frame_ms": client.ms,
              "loss": [m["loss"] for _, _, m in client.replies]}
    return report, launches


def vgg_flop(res: int) -> int:
    """Multiply-adds x 2 of LPIPS's 13 convolutions on one res x res image."""
    flop, cin = 0, 3
    for b, (cout, n) in enumerate(lpips._VGG_BLOCKS):
        for _ in range(n):
            flop += 2 * cin * cout * 9 * (res >> b) ** 2
            cin = cout
    return flop


def lpips_check(model_dir: Path, out_dir: Path, it: int) -> dict:
    """LPIPS on random weights: the card against the CPU at LPIPS_RES, an
    800x800 pair timed, and cli.metrics with its LPIPS column on the model."""
    rng = np.random.default_rng(0)
    arrays, cin, idx = {}, 3, 0
    for cout, n in lpips._VGG_BLOCKS:
        for _ in range(n):
            arrays[f"conv{idx}_w"] = rng.normal(scale=0.05, size=(cout, cin, 3, 3)
                                                ).astype(np.float32)
            arrays[f"conv{idx}_b"] = np.zeros(cout, np.float32)
            cin, idx = cout, idx + 1
    for i, (cout, _) in enumerate(lpips._VGG_BLOCKS):
        arrays[f"lin{i}_w"] = np.abs(rng.normal(size=cout)).astype(np.float32)
    path = out_dir / "lpips_random.npz"
    np.savez(path, **arrays)

    rng = np.random.default_rng(1)
    a, b, a8, b8 = (torch.from_numpy(rng.random((3, r, r), dtype=np.float32))
                    for r in (LPIPS_RES, LPIPS_RES, W, W))
    on_card = lpips.lpips_fn(str(path))
    got_t = on_card(a.cuda(), b.cuda())
    got = float(got_t)
    want = float(lpips.lpips_fn(str(path), device="cpu")(a, b))
    rel = abs(got - want) / abs(want)
    if not (math.isfinite(got) and rel <= LPIPS_TOL):
        fail(f"LPIPS: card {got} against CPU {want} at {LPIPS_RES}x{LPIPS_RES}, rel {rel} "
             f"(tol {LPIPS_TOL})")
    a8, b8 = a8.cuda(), b8.cuda()
    ms = cuda_ms(lambda: on_card(a8, b8), reps=10, warmup=2)
    flop = 2 * vgg_flop(W)

    with mock.patch.dict(os.environ, {"TPU2DGS_LPIPS_WEIGHTS": str(path)}):
        cli_metrics.main(["-m", str(model_dir)])
    renders = sorted(os.listdir(model_dir / "test" / f"ours_{it}" / "renders"))
    with open(model_dir / "per_view.json") as f:
        per_view = json.load(f)[f"ours_{it}"]["LPIPS"]
    with open(model_dir / "results.json") as f:
        results = json.load(f)[f"ours_{it}"]
    if sorted(per_view) != renders or not all(math.isfinite(v) for v in per_view.values()) \
            or results["LPIPS"] is None or not math.isfinite(results["LPIPS"]):
        fail(f"cli.metrics with LPIPS: per view {per_view} for {renders}, results {results}")
    path.unlink()
    return {"weights": "random, seed 0 (the released LPIPS weights are not in the "
                       "repository): values are not comparable with published LPIPS",
            "card_vs_cpu": {"res": LPIPS_RES, "card": got, "cpu": want, "rel_err": rel,
                            "tol": LPIPS_TOL, "card_device": str(got_t.device)},
            "ms_800": ms, "flop_800_pair": flop, "tflop_s_800": flop / ms / 1e9,
            "bound_ms_800": flop / PEAK_F32_S * 1e3,
            "cli_metrics": {"per_view": per_view, "results": results}}


def viewer(model_dir: Path, out_dir: Path, it: int):
    """The viewer main path on the command-line phase's model (cli.view's
    frames), beside it Trainer(gui=) on the shell training set, and LPIPS.
    Returns the launches of the served frames and the trainer, and the
    phase's seconds."""
    t0 = time.perf_counter()
    served, served_launches = served_frames(model_dir, it)
    t1 = time.perf_counter()
    training, train_launches = gui_training()
    t2 = time.perf_counter()
    lp = lpips_check(model_dir, out_dir, it)
    seconds = {"served": t1 - t0, "training": t2 - t1, "lpips": time.perf_counter() - t2}
    emit({"phase": "viewer", "card": card(), "served": served, "training": training,
          "lpips": lp, "seconds": seconds,
          "note": "frame ms: host clock in the client thread of the same process, from the "
                  "request sent to the metrics received; render ms: ModelView.render between "
                  "two synchronizes"})
    return Counter(served_launches) + Counter(train_launches), sum(seconds.values())


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


def render_heals(model_dir: Path, flags: list[str]) -> dict:
    """cli.render --skip_mesh at `flags`: the caps it returned, its
    healer's views, renders, re-renders, growth events and the counters
    that still fired at their ceilings."""
    healers = []
    with record_calls(capacity.CapacityHealer, "render", healers):
        caps = cli_render.main(["-m", str(model_dir), "--skip_mesh", "--quiet", *flags])
    healer = healers[0][0][0]
    return {"caps": caps, "views": healer.views, "renders": healer.renders,
            "rerenders": healer.rerenders, "events": healer.events,
            "truncated": healer.truncated}


def written_files(model_dir: Path, it: int) -> dict[str, bytes]:
    """The bytes of every PNG and depth TIFF cli.render wrote."""
    return {str(f.relative_to(model_dir)): f.read_bytes()
            for split in ("train", "test")
            for sub, pattern in (("renders", "*.png"), ("vis", "*.tiff"))
            for f in sorted((model_dir / split / f"ours_{it}" / sub).glob(pattern))}


def cli(out_dir: Path, mesh_fn=mesh, with_viewer: bool = True):
    """The command-line main path at full width: a COLMAP dataset of the
    shell training set on disk, cli.train from a fresh start (spherical
    harmonics degree 0, as every run starts, ground truth over its device
    budget), a resume from its checkpoint stamped with step 3000 (degree 3,
    distortion loss on), cli.render (at capacities where no counter fires,
    then at the default flags, which must heal to the same files) and
    cli.metrics; then `mesh_fn` (the mesh phase, none if None) and, unless
    `with_viewer` is false, the viewer phase on its model. Returns
    the launches of all of it and the two phases' seconds."""
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
    # At capacities where no counter fires, then at cli.train's default
    # capacity flags, which heal: the same files, byte for byte.
    room = render_heals(model_dir, [f"--{k}={v}" for k, v in GT_CAPS.items()])
    if room["rerenders"] or room["truncated"] or room["caps"] != GT_CAPS:
        fail(f"cli.render at {GT_CAPS}: a counter fired: {room}")
    room_files = written_files(model_dir, last)
    native.LAUNCHES.clear()
    t0 = time.perf_counter()
    with watch.watch(Scene, "load", "render_scene_load"), \
            watch.watch(splats_lib, "load_ply", "render_load_ply"):
        healed = render_heals(model_dir, [])
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    healed_files = written_files(model_dir, last)
    got = dict(native.LAUNCHES)
    launches.update(got)
    if healed["views"] != CLI_VIEWS or got != {"select_values": 3 * healed["renders"],
                                               "blend_tiles": healed["renders"]}:
        fail(f"cli.render: {healed['views']} views and {healed['rerenders']} re-renders "
             f"launched {got}, want K1 3 and K2 1 a render")
    differ = [name for name in room_files if healed_files.get(name) != room_files[name]]
    if healed["truncated"] or differ or set(healed_files) != set(room_files):
        fail(f"cli.render at the default flags: truncated {healed['truncated']}; files "
             f"differing from those at {GT_CAPS}: {differ}")
    render_heal = {**healed, "files_equal": len(room_files)}

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
    settings = api.RasterSettings(W, H, **healed["caps"])
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
    summary_check(out_dir, model_dir, results)

    mesh_s = 0.0
    if mesh_fn is not None:
        mesh_launches, mesh_s = mesh_fn(model_dir, n_train, last)
        launches.update(mesh_launches)
    viewer_s = 0.0
    if with_viewer:
        viewer_launches, viewer_s = viewer(model_dir, out_dir, last)
        launches.update(viewer_launches)

    # cli.render's seconds less its loads: its renders, re-renders included,
    # and the files it writes
    render_host_s = (render_s - sum(watch.seconds["render_scene_load"])
                     - sum(watch.seconds["render_load_ply"]))
    steps_ms = [1e3 * s / n for s, n in ((sum(watch.seconds["train_block"]), first),
                                         (sum(watch.seconds["train_block_resumed"]),
                                          CLI_RESUME_STEPS))]
    emit({"phase": "cli", "views": CLI_VIEWS, "train_views": n_train, "points": N_SPLATS,
          "seconds": {"write_dataset": write_s, "first_run": first_s, "resumed_run": resume_s,
                      "render": render_s, "metrics": metrics_s, "load_ply": load_ply_s,
                      **watch.totals()},
          "step_ms_fresh_host_gt": steps_ms[0], "step_ms_resumed_sh3": steps_ms[1],
          "render_ms_per_view": 1e3 * render_host_s / CLI_VIEWS,
          "render_ms_per_render": 1e3 * render_host_s / healed["renders"],
          "render_heal": render_heal,
          "logged_l1": l1, "logged_total": total, "results": results,
          "png_max_abs_err": png_err, "depth_max_abs_err": depth_err,
          "num_live": int(reloaded.num_live())})
    shutil.rmtree(scene_dir)
    shutil.rmtree(model_dir)
    return launches, mesh_s, viewer_s


def r128(x) -> int:
    return max(128, -(-int(float(x)) // 128) * 128)


def timed_ms(fn):
    """(fn(), host ms of the call ending in a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def in_dtype(cam, scene, bg, dtype):
    return (type(cam)(*(a.to(dtype) for a in cam)), [a.to(dtype) for a in scene], bg.to(dtype))


def with_depth_accum(out: dict) -> dict:
    return {**out, "depth_accum": out["depth_expected"] * out["rend_alpha"]}


def held_to(out, ref, listed=()) -> dict:
    """Per map: max |d| against `ref` and the pixels past the render
    tolerance in any channel; those of the `listed` maps printed with the
    reference's alpha and transmittance there."""
    alpha = ref["rend_alpha"][0]
    info = {}
    for k in (*KEYS, "depth_accum"):
        diff = (out[k] - ref[k]).abs()
        past = torch.nonzero((diff - RENDER_TOL * ref[k].abs()).amax(0) > RENDER_TOL)
        info[k] = {"max_abs": float(diff.max()), "pixels_past": len(past),
                   "share_past": len(past) / alpha.numel()}
        if k in listed:
            at = diff.amax(0)[past[:, 0], past[:, 1]]
            info[k]["past"] = [{"y": y, "x": x, "abs": a, "alpha": float(alpha[y, x]),
                                "transmittance": 1.0 - float(alpha[y, x])}
                               for (y, x), a in zip(past.tolist(), at.tolist())]
    return info


@torch.no_grad()
def full_width_forward():
    """One 800x800 shell view through the cuda and tiled backends and the
    oracle in float32 and float64, at capacities raised until no overflow
    counter of either binned backend fires. cuda and tiled are gated
    against the float32 oracle; all three float32 renders are held to the
    float64 one and reported."""
    cam, scene = synthetic.make_shell_scene(W, H, N_SPLATS)
    bg = torch.zeros(3, device=scene[0].device)
    caps = dict(GT_CAPS)
    for _ in range(3):
        outs = {be: api.render(cam, api.RasterSettings(W, H, backend=be, **caps), *scene, bg)
                for be in ("cuda", "tiled")}
        fired = {(be, k): float(o[k]) for be, o in outs.items() for k in
                 ("tile_overflow_frac", "bin_overflow_frac", "col_overflow_frac",
                  "vis_overflow") if k in o and float(o[k]) > 0.0}
        if not fired:
            break
        for kwarg, demand in (("tile_capacity", "tile_count_max"),
                              ("bin_capacity", "bin_count_max"),
                              ("col_capacity", "col_count_max")):
            caps[kwarg] = max([caps[kwarg]] + [r128(o[demand]) for o in outs.values()
                                               if demand in o])
    else:
        fail(f"backends: overflow counters still fire at {caps}: {fired}")
    ms = {}
    for be in ("cuda", "tiled", "oracle"):
        settings = api.RasterSettings(W, H, backend=be, **caps)
        outs[be], ms[be] = timed_ms(lambda: api.render(cam, settings, *scene, bg))
    cam64, scene64, bg64 = in_dtype(cam, scene, bg, torch.float64)
    ref64, ms["oracle64"] = timed_ms(lambda: api.render(
        cam64, api.RasterSettings(W, H, backend="oracle"), *scene64, bg64))
    outs = {be: with_depth_accum(o) for be, o in outs.items()}
    ref = outs["oracle"]
    splats = preprocess.preprocess(*scene, cam, W, H, 3)
    c_max = {"render": float(splats.color[splats.visible].abs().max()), "rend_alpha": 1.0,
             "rend_normal": 1.0}
    held = {be: held_to(outs[be], ref, LISTED_MAPS) for be in ("cuda", "tiled")}
    witness = {be: held_to(outs[be], with_depth_accum(ref64)) for be in ("cuda", "tiled", "oracle")}
    bad = {}
    for be, info in held.items():
        if not torch.equal(outs[be]["radii"], ref["radii"]):
            bad[be] = "radii differ"
        for k in GATED_MAPS:
            cap = FLIP_CAP * c_max[k] if k in c_max else math.inf
            if info[k]["share_past"] > FLIP_SHARE or info[k]["max_abs"] > cap:
                bad[f"{be} {k}"] = {"cap": cap, **{key: info[k][key] for key in
                                                   ("max_abs", "pixels_past", "share_past")}}
    return {"caps": caps, "ms": ms, "vs_oracle": held, "vs_oracle64": witness, "c_max": c_max,
            "alpha_mean": float(ref["rend_alpha"].mean()),
            "tile_count_max": {be: float(outs[be]["tile_count_max"]) for be in ("cuda", "tiled")},
            "failed": bad}


def oracle_gradients():
    """The training loss's gradient (photometric + 0.05 normal + 100
    distortion, loop.view_gradients' loss) on the bench generator's scene
    at GRAD_SCENE, through the kernels (K1 3, K2 1, K3 1 a backward pass)
    and through the oracle in float32, each against the oracle's in
    float64, per parameter as max |d| / that parameter's largest |float64
    gradient|:

    * gated for the kernels (<= GRAD_TOL): the gradient of the loss
      linearised at the float64 render, its derivative with respect to the
      maps (LOSS_MAPS) taken there once and sent back through each backend;
    * reported: the gradient of each backend's own loss. L1's derivative is
      the sign of render - target, so a channel-pixel whose float32 render
      and float64 render lie on either side of the target flips its whole
      photometric term; their count is reported beside it."""
    w, h, n = GRAD_SCENE
    cam, scene = synthetic.make_bench_scene(w, h, n)
    model = synthetic.scene_model(scene)
    gt = torch.full((3, h, w), 0.3, dtype=torch.float64, device=scene[0].device)
    bg = torch.zeros(3, device=scene[0].device)
    names = (*model.params._fields, "mean2d_offset")

    def forward(backend, dtype):
        params = splats_lib.SplatParams(*(a.detach().to(dtype).requires_grad_()
                                          for a in model.params))
        offset = torch.zeros((n, 2), dtype=dtype, device=gt.device, requires_grad=True)
        cam_d, _, bg_d = in_dtype(cam, scene, bg, dtype)
        out = api.render(cam_d, api.RasterSettings(w, h, backend=backend, **GRAD_SCENE_CAPS),
                         params.xyz, torch.exp(params.scaling), params.rotation,
                         torch.sigmoid(params.opacity[:, 0]), splats_lib.features(params),
                         bg_d, mean2d_offset=offset, live=model.live)
        photo, _ = loop.losses.photometric_loss(out["render"], gt.to(dtype), 0.2)
        total = (photo + 0.05 * loop.losses.normal_consistency_loss(out["rend_normal"],
                                                                    out["surf_normal"])
                 + 100.0 * loop.losses.distortion_loss(out["rend_dist"]))
        return out, total, (*params, offset)

    def rel(g, g64):
        return {name: {"max_abs_err": float((a.double() - b).abs().max()),
                       "grad_max": float(b.abs().max()),
                       "rel": float((a.double() - b).abs().max() / b.abs().max())}
                for name, a, b in zip(names, g, g64)}

    out64, loss64, inputs64 = forward("oracle", torch.float64)
    maps64 = [out64[k] for k in LOSS_MAPS]
    cot = torch.autograd.grad(loss64, maps64, retain_graph=True)
    g64 = torch.autograd.grad(maps64, inputs64, cot)
    result, bad = {}, {}
    for be in ("cuda", "oracle"):
        before = dict(native.LAUNCHES)
        out, loss, inputs = forward(be, torch.float32)
        own = torch.autograd.grad(loss, inputs, retain_graph=True)
        lin = torch.autograd.grad([out[k] for k in LOSS_MAPS], inputs,
                                  [c.to(torch.float32) for c in cot])
        torch.cuda.synchronize()
        launched = {k: native.LAUNCHES.get(k, 0) - before.get(k, 0)
                    for k in ("select_values", "blend_tiles", "blend_tiles_backward")}
        signs = int(((out["render"].double() - gt).sign() != (out64["render"] - gt).sign()).sum())
        result[be] = {"linearised": rel(lin, g64), "own_loss": rel(own, g64),
                      "l1_sign_flips": signs, "launches": launched}
        if be == "cuda":
            if launched != {"select_values": 3, "blend_tiles": 1, "blend_tiles_backward": 2}:
                fail(f"backends: the gradients through the kernels launched {launched}, "
                     "want 3 / 1 / 2 (two backward passes)")
            overflow = {k: float(out[k]) for k in OVERFLOW if k.endswith(("_frac", "overflow"))
                        and k in out}
            if any(overflow.values()):
                fail(f"backends: the gradient scene overflows {overflow}")
            bad = {k: v for k, v in result[be]["linearised"].items()
                   if not (math.isfinite(v["rel"]) and v["grad_max"] > 0.0
                           and v["rel"] <= GRAD_TOL)}
    return result, bad


def backend_times():
    """Served-view and training-step ms of the tiled backend at 800x800 on
    the shell scene at the bench capacities, beside the cuda backend's
    (host clock ending in a synchronize; median of BACKEND_REPS after a
    warm-up), with each step's peak device memory."""
    cam, scene = synthetic.make_shell_scene(W, H, N_SPLATS)
    model = synthetic.scene_model(scene)
    bg = torch.zeros(3, device=scene[0].device)
    caps = {k: v for k, v in CAPS.items() if k != "grad_pack_capacity"}
    with torch.no_grad():
        gt = api.render(cam, api.RasterSettings(W, H, **GT_CAPS), *scene, bg)["render"]
    times = {}
    for be in ("cuda", "tiled"):
        settings = api.RasterSettings(W, H, backend=be, **caps)

        def view():
            with torch.no_grad():
                return api.render(cam, settings, *scene, bg)

        def step():
            return loop.view_gradients(model, settings, cam, gt, bg, 0.2, 0.05, 100.0)

        row = {}
        for name, fn in (("view", view), ("step", step)):
            fn()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            row[f"{name}_ms"] = sorted(timed_ms(fn)[1] for _ in range(BACKEND_REPS))
            row[f"{name}_ms_median"] = row[f"{name}_ms"][BACKEND_REPS // 2]
            row[f"{name}_peak_bytes"] = torch.cuda.max_memory_allocated() - base
        times[be] = row
    return times


def select_rows_check() -> dict:
    """select_rows (K1 with an iota channel) on the card against its plain
    version on the CPU: bit-equal positions and counts, one launch."""
    rng = np.random.default_rng(0)
    np_, m, r, cap = 3, 4096, 64, 256
    cx0 = rng.uniform(0, 800, (np_, m)).astype(np.float32)
    cy0 = rng.uniform(0, 800, (np_, m)).astype(np.float32)
    boxes = [torch.from_numpy(a) for a in (
        cx0, cx0 + rng.uniform(5, 60, (np_, m)).astype(np.float32),
        cy0, cy0 + rng.uniform(5, 60, (np_, m)).astype(np.float32))]
    rx0 = torch.from_numpy(rng.uniform(0, 700, r).astype(np.float32))
    ry0 = torch.from_numpy(rng.uniform(0, 700, r).astype(np.float32))
    rects = (rx0, rx0 + 127, ry0, ry0 + 63)
    parent = torch.from_numpy(rng.integers(0, np_, r).astype(np.int32))
    want = select_kernel.select_rows(rects, boxes, parent, cap)
    before = native.LAUNCHES.get("select_values", 0)
    got = select_kernel.select_rows([a.cuda() for a in rects], [a.cuda() for a in boxes],
                                    parent.cuda(), cap)
    launches = native.LAUNCHES.get("select_values", 0) - before
    if launches != 1 or not all(torch.equal(a.cpu(), b) for a, b in zip(got, want)):
        fail(f"select_rows: {launches} launches, equal to plain: "
             f"{[torch.equal(a.cpu(), b) for a, b in zip(got, want)]}")
    return {"rows": r, "candidates": m, "cap": cap, "launches": launches,
            "hits_max": int(want[1].max())}


def backends():
    """The oracle and tiled backends on the card, and the kernels held
    against the oracle. Returns the kernels' launches of the phase (the
    cuda renders and the gradient; select_rows' comparison launch is not
    counted)."""
    t0 = time.perf_counter()
    native.LAUNCHES.clear()
    forward = full_width_forward()
    grads, grads_bad = oracle_gradients()
    times = backend_times()
    launches = dict(native.LAUNCHES)
    rows = select_rows_check()
    emit({"phase": "backends", "seconds": time.perf_counter() - t0, "launches": launches,
          "forward_800": forward, "grad_scene": GRAD_SCENE, "grad_vs_oracle": grads,
          "times_800": times, "select_rows": rows, "card": card()})
    if forward["failed"]:
        fail(f"backends: against the oracle at 800x800 (at most {FLIP_SHARE} of a map's "
             f"pixels past {RENDER_TOL} (1 + |v|), a summed map within {FLIP_CAP} max|c| "
             f"at every pixel): {forward['failed']}")
    if grads_bad:
        fail(f"backends: the gradients through the kernels differ from the float64 "
             f"oracle's by more than {GRAD_TOL} of each parameter's largest: {grads_bad}")
    return launches


def quality_gate_phase(out_dir: Path):
    """eval.quality_gate at its defaults; fails unless the gate passes.
    Every training step launches K1 3, K2 1 and K3 1 times."""
    gate_dir = out_dir / "qgate"
    shutil.rmtree(gate_dir, ignore_errors=True)
    steps = []
    watch = Stopwatch()
    native.LAUNCHES.clear()
    t0 = time.perf_counter()
    with rehearsal.per_call(loop, "train_step", steps), \
            watch.watch(loop.Trainer, "train", "train"), \
            watch.watch(cli_render, "extract_mesh", "mesh"):
        report = quality_gate.main(str(gate_dir), *QGATE)
    seconds = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    iters = QGATE[0]
    if len(steps) != iters:
        fail(f"quality_gate: {len(steps)} steps, want {iters}")
    check_calls("quality_gate steps", steps, STEP_LAUNCHES)
    emit({"phase": "quality_gate", "seconds": seconds, "launches": launches,
          "psnr_db": report["psnr_db"], "render_capacities": report["render_capacities"],
          "train_seconds": sum(watch.seconds["train"]),
          "steps_per_s": iters / sum(watch.seconds["train"]),
          "mesh_seconds": sum(watch.seconds["mesh"]), "report": report, "card": card()})
    if not report["pass"]:
        fail(f"quality_gate: the gate failed: {report}")
    shutil.rmtree(gate_dir)
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


def strip_lists(splats, settings, bg, **strip):
    """rasterize_cuda of a strip or window of the shell view (the kernels),
    its lists and counts as the blend kernel got them, and its device ms."""
    blends = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with record_calls(cuda_backend, "blend_tiles", blends):
        start.record()
        img, allmap = cuda_backend.rasterize_cuda(splats, settings, bg, **strip)
        end.record()
    end.synchronize()
    rec3, counts = blends[0][0][:2]
    return img, allmap, rec3, counts, start.elapsed_time(end)


def fired(allmap) -> dict:
    """The overflow counters of a backend's allmap that fired."""
    return {k: float(allmap[f"_aux_{k}"]) for k in FIRES if float(allmap[f"_aux_{k}"]) > 0}


def split_check(splats, settings, bg, full, n_dev: int, balanced: bool) -> dict:
    """The shell view rendered strip by strip (static, `n_dev` strips of
    whole coarse-bin rows) or window by window (`balanced`, the work
    quantiles), at capacities where no counter fires, stitched: each tile's
    list equal to the full frame's less the entries whose binning box
    misses the strip's rows, and every pixel bit-equal.

    The less: binning's L2 and L3 test exact coverage alone, and the conic
    of a surfel seen near edge-on can be a hyperbola whose far branch
    reaches tiles its box does not; no pixel passes the blend's test there.
    L1 tests the box against the strip's (or the window's) rows, so a strip
    drops such an entry where the full frame, binning all rows, keeps it
    in its lists (in the JAX package as in the port)."""
    full_img, full_rec3, full_counts, y0_of, y1_of = full
    by, cby = cuda_backend.BY, cuda_backend.CBY
    nty, nbx = -(-H // by), -(-W // cuda_backend.BX)
    if balanced:  # as parallel/sharded.py renders a window
        c, e = splats.box_center, splats.box_half
        b = sharded._balance_boundaries(c[:, 0] - e[:, 0], c[:, 0] + e[:, 0], c[:, 1] - e[:, 1],
                                        c[:, 1] + e[:, 1], splats.visible, W, nty, n_dev,
                                        tile_cap=settings.tile_capacity).tolist()
        parts = [(lo // cby * cby, max(hi - lo // cby * cby, 1), lo, hi)
                 for lo, hi in zip(b[:-1], b[1:])]
    else:  # strips of whole coarse-bin rows; the last may lie below the image
        per = -(-(-(-nty // n_dev)) // cby) * cby
        parts = [(d * per, per, min(d * per, nty), min((d + 1) * per, nty))
                 for d in range(n_dev)]
    rows, works, ms, buffer_rows, dropped = [], [], [], [], 0
    label = f"{'windows' if balanced else 'strips'} x{n_dev}"
    for row0, n_loc, lo, hi in parts:
        win = dict(row_lo=lo, row_hi=hi) if balanced else {}
        img, allmap, rec3, counts, t_ms = strip_lists(splats, settings, bg, tile_row0=row0,
                                                      nty_local=n_loc, **win)
        if fired(allmap):
            fail(f"rows: {label}: counters fired {fired(allmap)}; the check needs room")
        ms.append(t_ms)
        works.append(float(allmap["_aux_strip_work"]))
        buffer_rows.append(img.shape[0])
        rows.append(img[max(lo - row0, 0) * by:max(hi - row0, 0) * by])
        if hi <= lo:
            continue
        ylo, yhi = ((lo, hi) if balanced else (row0, row0 + n_loc))
        tix = torch.arange(nbx, device=rec3.device)[:, None]
        ty = torch.arange(lo, hi, device=rec3.device)[None, :]
        t, tf = (tix * n_loc + ty - row0).reshape(-1), (tix * nty + ty).reshape(-1)
        slot = torch.arange(rec3.shape[2], device=rec3.device)[None, :]
        f_ids = full_rec3[tf, 21].long()
        f_live = slot < full_counts[tf, None]
        keep = f_live & (y0_of[f_ids] <= yhi * by - 1) & (y1_of[f_ids] >= ylo * by)
        s_live = slot < counts[t, None]
        same = (torch.equal(keep.sum(1), counts[t].long())
                and torch.equal(f_ids[keep], rec3[t, 21].long()[s_live]))
        if not same:
            fail(f"rows: {label}: the lists of tile rows {lo}..{hi - 1} are not the full "
                 "frame's less the entries whose box misses the strip's rows")
        dropped += int((f_live & ~keep).sum())
    stitched = torch.cat(rows)[:H, :W]
    if not bits_equal(stitched, full_img):
        fail(f"rows: {label}: stitched image differs from the full frame at "
             f"{int((stitched != full_img).any(-1).sum())} pixels")
    mean = float(np.mean(works))
    return {"rows": [p[2:] for p in parts], "strip_ms": ms, "strip_work": works,
            "work_max_over_mean": max(works) / mean if mean else None,
            "buffer_rows": buffer_rows, "far_branch_entries_dropped": dropped}


def rows_phase() -> dict:
    """Tile-row multi-device rendering and training on the 800x800 shell:
    K2 and K3 at a row offset against their plain versions at the bench
    capacities; then, at the ground truth's capacities (no counter fires),
    strips and work windows stitched against the full frame, and two ranks
    sharing cuda:0 over gloo (render(mesh=) and Trainer(mesh=)) against
    one. Returns the two ranks' launches (the main path's, counted
    from zero in each rank) and the K2 and K3 checks at the row offset."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    settings = api.RasterSettings(W, H, **CAPS)
    # The stitched and two-rank checks run where no counter fires: at the
    # bench capacities some of the shell's tiles overflow, and a strip keeps
    # other deepest entries of an overflowing list than the full frame.
    roomy = api.RasterSettings(W, H, **GT_CAPS)
    cam, scene = synthetic.make_shell_scene(W, H, N_SPLATS)
    bg = torch.zeros(3, device=dev)
    nty = -(-H // cuda_backend.BY)
    with torch.no_grad():
        xyz, scaling, rotation, opacity, feats = scene
        splats = preprocess.preprocess(xyz, scaling, rotation, opacity.reshape(-1), feats, cam,
                                       W, H, settings.sh_degree)
        # K2 and K3 on rank 1's strip of a two-way split: tile rows 28 .. 55
        per = -(-(-(-nty // 2)) // cuda_backend.CBY) * cuda_backend.CBY
        _, _, rec3, counts, _ = strip_lists(splats, settings, bg, tile_row0=per, nty_local=per)
    blend = blend_check(rec3, counts, per, row0=per)
    bwd = backward_check(rec3, counts, per, row0=per)
    del rec3, counts

    with torch.no_grad():
        full_img, full_map, full_rec3, full_counts, full_ms = strip_lists(splats, roomy, bg)
        if fired(full_map):
            fail(f"rows: full frame counters fired {fired(full_map)}; the check needs room")
        comp = binning.compact_visible(splats, N_SPLATS)
        y0_of = torch.empty_like(comp.y0).index_put_((comp.perm,), comp.y0)
        y1_of = torch.empty_like(comp.y1).index_put_((comp.perm,), comp.y1)
        full = (full_img, full_rec3, full_counts, y0_of, y1_of)
        splits = {f"{mode} x{d}": split_check(splats, roomy, bg, full, d, mode == "windows")
                  for mode in ("strips", "windows") for d in ROWS_SPLITS}
        del full, full_rec3, comp
    emit({"phase": "rows", "card": card(), "capacities": GT_CAPS, "full_frame_ms": full_ms,
          "splits": splits})

    # Two ranks on one card: gloo, each collective staged through host
    # memory. This checks results; it measures no scaling.
    cam_obj = synthetic.shell_camera(2 * np.pi * 0.13, W, H)
    scene_np = tuple(a.cpu().numpy() for a in scene)
    bg_np = np.zeros(3, np.float32)
    modes = [api.RasterSettings(W, H, **GT_CAPS, row_balance=rb) for rb in ("static", "work")]
    cams, model = synthetic.make_shell_training_set(W, H, N_SPLATS, views=TRAIN_VIEWS,
                                                   **GT_CAPS)
    start = rehearsal.model_arrays(model)
    del model
    kw = dict(spatial_lr_scale=1.0, scene_extent=1.0,
              train_cfg=loop.TrainConfig(normal_from_iter=0, dist_from_iter=0,
                                         lambda_dist=100.0),
              raster_kwargs=dict(GT_CAPS))
    t0 = time.perf_counter()
    both = distributed.spawn(
        rehearsal.each, ROWS_RANKS,
        args=([(rehearsal.render_rank, (cam_obj, modes, scene_np, bg_np)),
               (rehearsal.train_rank, (start, cams, W, H, (ROWS_STEPS,), kw, 3))],),
        device=[dev] * ROWS_RANKS, timeout_s=300)
    ranks_s = time.perf_counter() - t0
    ranks, trained = zip(*both)
    one = [rehearsal.render_once(cam_obj, s, scene_np, bg_np, dev) for s in modes]
    launches = Counter()
    rendered = {}
    per_render = {"select_values": 3, "blend_tiles": 1, "blend_tiles_backward": 1}
    for i, s in enumerate(modes):
        got = [r[i] for r in ranks]
        for g in got:
            if g["launches"] != per_render:
                fail(f"rows: a rank's render(mesh=) launched {g['launches']}, want {per_render}")
            launches.update(g["launches"])
        err = {k: float(np.abs(got[0][k] - one[i][k]).max()) for k in rehearsal.KEYS}
        ovf = {k: float(got[0][k].max()) for k in FIRES if float(got[0][k].max()) > 0}
        if (max(err.values()) > RENDER_TOL or ovf
                or not np.array_equal(got[0]["radii"], one[i]["radii"])):
            fail(f"rows: two-rank render ({s.row_balance}) against one rank: {err}, "
                 f"counters fired: {ovf}")
        grad = {}
        for p in rehearsal.PARAMS:
            a, b = got[0][f"grad_{p}"], one[i][f"grad_{p}"]
            grad[p] = {"max_abs_err": float(np.abs(a - b).max()),
                       "grad_max": float(np.abs(b).max())}
        floor = GRAD_FLOOR * max(v["grad_max"] for v in grad.values())
        bad = {k: v for k, v in grad.items()
               if not v["max_abs_err"] <= max(GRAD_TOL * v["grad_max"], floor)}
        if bad or any(not np.array_equal(got[0][f"grad_{p}"], got[1][f"grad_{p}"])
                      for p in rehearsal.PARAMS):
            fail(f"rows: two-rank gradients ({s.row_balance}) against one rank: {grad}")
        rendered[s.row_balance] = {"max_abs_err": err, "grad": grad,
                                   "strip_rows": got[0]["strip_rows"].tolist(),
                                   "strip_work": got[0]["strip_work"].tolist()}

    alone = rehearsal.train_once(start, cams, W, H, (ROWS_STEPS,), kw, dev, sh_degree=3)
    per_step = {"select_values": 3, "blend_tiles": 1, "blend_tiles_backward": 1}
    for r in trained:
        if r["launches"] != [per_step] * ROWS_STEPS:
            fail(f"rows: a rank's Trainer steps launched {r['launches']}, want {per_step} each")
        for step in r["launches"]:
            launches.update(step)
    loss = np.array(trained[0]["loss"])
    ref = np.array(alone["loss"])
    if trained[0]["loss"] != trained[1]["loss"] or not np.allclose(loss, ref, rtol=2e-3,
                                                                    atol=0.0):
        fail(f"rows: two-rank losses {[r['loss'] for r in trained]} against one rank {ref}")
    p0, p1 = (r["stops"][0]["params"] for r in trained)
    if any(not np.array_equal(p0[k], p1[k]) for k in p0):
        fail("rows: the two ranks' parameters differ")
    emit({"phase": "rows", "card": card(), "ranks": ROWS_RANKS, "backend": "gloo on cuda:0",
          "ranks_seconds": ranks_s, "render": rendered,
          "train_steps": ROWS_STEPS, "loss": trained[0]["loss"], "loss_one_rank": alone["loss"],
          "xyz_max_abs_vs_one_rank": float(np.abs(p0["xyz"] - alone["stops"][0]["params"]
                                                  ["xyz"]).max()),
          "launches_per_rank": trained[0]["launches"][0],
          "seconds": time.perf_counter() - t_phase})
    return dict(launches), blend, bwd


def splats_phase() -> dict:
    """Splat-sharded rendering and training on the 800x800 shell at the
    ground truth's capacities (no list overflows): two ranks sharing
    cuda:0 over gloo, each holding its half of the splat rows, against one
    rank. Returns the two ranks' launches (each render and step counted
    from zero in its rank)."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    d = SPLAT_RANKS
    n_loc = N_SPLATS // d
    k_loc = n_loc  # no vis_capacity: every rank keeps all its rows' survivors
    cam_obj = synthetic.shell_camera(2 * np.pi * 0.13, W, H)
    _, scene = synthetic.make_shell_scene(W, H, N_SPLATS)
    scene_np = tuple(a.cpu().numpy() for a in scene)
    bg_np = np.zeros(3, np.float32)
    modes = {f"{rb} {'routed' if x else 'all-gather'}":
             api.RasterSettings(W, H, **GT_CAPS, row_balance=rb, xfer_capacity=x)
             for rb in ("static", "work") for x in (0, k_loc)}
    small = api.RasterSettings(W, H, **GT_CAPS, row_balance="static",
                               xfer_capacity=SPLAT_XFER_SMALL)
    cams, model = synthetic.make_shell_training_set(W, H, N_SPLATS, views=TRAIN_VIEWS,
                                                   **GT_CAPS)
    start = rehearsal.model_arrays(model)
    del model
    cfg = dict(normal_from_iter=0, dist_from_iter=0, lambda_dist=100.0,
               densification_interval=4, grow_watermark=0.5)
    kw = dict(spatial_lr_scale=1.0, scene_extent=1.0, raster_kwargs=dict(GT_CAPS))
    sharded_kw = dict(kw, shard_splats=True,
                      train_cfg=loop.TrainConfig(densify_from_iter=2, **cfg))
    t0 = time.perf_counter()
    both = distributed.spawn(
        rehearsal.each, d,
        args=([(rehearsal.render_rank, (cam_obj, [*modes.values(), small], scene_np, bg_np,
                                        False, True)),
               (rehearsal.train_rank, (start, cams, W, H, (3, SPLAT_STEPS), sharded_kw, 3))],),
        device=[dev] * d, timeout_s=600)
    ranks_s = time.perf_counter() - t0
    ranks, trained = zip(*both)
    one = rehearsal.render_once(cam_obj, api.RasterSettings(W, H, **GT_CAPS), scene_np, bg_np,
                                dev)

    launches = Counter()
    per_render = {"select_values": 3, "blend_tiles": 1, "blend_tiles_backward": 1}
    rendered = {}
    for i, (name, s) in enumerate(modes.items()):
        got = [r[i] for r in ranks]
        for g in got:
            if g["launches"] != per_render:
                fail(f"splats: a rank's render ({name}) launched {g['launches']}, want "
                     f"{per_render}")
            launches.update(g["launches"])
        err = {k: float(np.abs(got[0][k] - one[k]).max()) for k in rehearsal.KEYS}
        ovf = {k: float(got[0][k].max()) for k in FIRES if float(got[0][k].max()) > 0}
        radii = np.concatenate([g["radii"] for g in got])
        if max(err.values()) > RENDER_TOL or ovf or not np.array_equal(radii, one["radii"]):
            fail(f"splats: two-rank render ({name}) against one rank: {err}, counters fired: "
                 f"{ovf}, radii equal: {np.array_equal(radii, one['radii'])}")
        if any(not np.array_equal(got[0][k], got[1][k]) for k in rehearsal.KEYS):
            fail(f"splats: the two ranks' images differ ({name})")
        grad = {}
        for p in rehearsal.PARAMS:
            a, b = np.concatenate([g[f"grad_{p}"] for g in got]), one[f"grad_{p}"]
            grad[p] = {"max_abs_err": float(np.abs(a - b).max()),
                       "grad_max": float(np.abs(b).max())}
        floor = GRAD_FLOOR * max(v["grad_max"] for v in grad.values())
        bad = {k: v for k, v in grad.items()
               if not v["max_abs_err"] <= max(GRAD_TOL * v["grad_max"], floor)}
        if bad:
            fail(f"splats: two-rank gradients ({name}) against one rank: {grad}")
        rendered[name] = {"max_abs_err": err, "grad": grad,
                          "seconds": [g["seconds"] for g in got],
                          "strip_rows": got[0]["strip_rows"].tolist(),
                          "strip_work": got[0]["strip_work"].tolist()}
        if s.xfer_capacity:
            gathered = ranks[0][list(modes).index(name.replace("routed", "all-gather"))]
            routed_err = max(float(np.abs(got[0][k] - gathered[k]).max()) for k in rehearsal.KEYS)
            if routed_err > SPLAT_ROUTED_TOL or float(got[0]["xfer_overflow_frac"]) != 0.0:
                fail(f"splats: routed render ({name}) against the all-gather one: {routed_err}, "
                     f"xfer_overflow_frac {float(got[0]['xfer_overflow_frac'])}")
            rendered[name].update(routed_vs_all_gather=routed_err,
                                  xfer_count_max=float(got[0]["xfer_count_max"]))

    # The overflowing exchange: each rank's message demand on each static
    # strip, counted from its survivors' boxes.
    got = [r[len(modes)] for r in ranks]
    for g in got:
        launches.update(g["launches"])
    nty = -(-H // cuda_backend.BY)
    rows_per = sharded._strip_rows(H, cuda_backend.BY, cuda_backend.CBY, d)
    bnd = [min(k * rows_per, nty) * cuda_backend.BY for k in range(d + 1)]
    demand = []
    with torch.no_grad():
        arrays = [torch.as_tensor(a, device=dev) for a in scene_np]
        for r in range(d):
            rows = [a[r * n_loc:(r + 1) * n_loc] for a in arrays]
            sp = preprocess.preprocess(rows[0], rows[1], rows[2], rows[3].reshape(-1), rows[4],
                                       cam_obj.arrays(dev), W, H, 3)
            comp = binning.compact_visible(sp, k_loc)
            demand.append([int(torch.sum(comp.valid & (comp.y0 <= bnd[k + 1] - 1)
                                         & (comp.y1 >= bnd[k]))) for k in range(d)])
    want_frac = max(float(np.mean(np.array(row) > SPLAT_XFER_SMALL)) for row in demand)
    overflow = {"xfer_capacity": SPLAT_XFER_SMALL, "demand": demand,
                "xfer_count_max": float(got[0]["xfer_count_max"]),
                "xfer_overflow_frac": float(got[0]["xfer_overflow_frac"])}
    if not (overflow["xfer_overflow_frac"] > 0 and overflow["xfer_overflow_frac"] == want_frac
            and overflow["xfer_count_max"] == max(map(max, demand))):
        fail(f"splats: overflow counters {overflow} against the demand from the boxes")

    # One rank's training in a process of its own, as each sharded rank is,
    # so the peaks compare like for like (both from the start of the run).
    t0 = time.perf_counter()
    (alone,), = distributed.spawn(
        rehearsal.each, 1,
        args=([(rehearsal.train_alone, (start, cams, W, H, (3, 4), dict(
            kw, train_cfg=loop.TrainConfig(densify_from_iter=10_000, **cfg)), 3))],),
        device=[dev], timeout_s=300)
    alone_s = time.perf_counter() - t0
    per_step = {"select_values": 3, "blend_tiles": 1, "blend_tiles_backward": 1}
    for r in trained:
        if r["launches"] != [per_step] * SPLAT_STEPS:
            fail(f"splats: a rank's Trainer steps launched {r['launches']}, want {per_step} "
                 "each")
        for step in r["launches"]:
            launches.update(step)
        for stop in r["stops"]:
            if stop["rows"] != [stop["capacity"] // d]:
                fail(f"splats: a rank holds {stop['rows']} rows at step {stop['step']} of a "
                     f"capacity of {stop['capacity']}")
    rounds = trained[0]["rounds"]  # rank 0 holds the gathered states
    if [len(r["rounds"]) for r in trained] != [1] * d or not all(
            x["live_equal"] and x["adam_equal"] and x["params_rel_err"] <= 1e-6
            for x in rounds):
        fail(f"splats: densification rounds against densify_and_prune(segments={d}): "
             f"{rounds}")
    first, last = trained[0]["stops"]
    if not last["capacity"] > first["capacity"]:
        fail(f"splats: no growth: capacity {first['capacity']} -> {last['capacity']}")
    loss = np.array(trained[0]["loss"][:4])
    ref = np.array(alone["loss"])
    if trained[0]["loss"] != trained[1]["loss"] or not np.allclose(loss, ref, rtol=2e-3,
                                                                    atol=0.0):
        fail(f"splats: two-rank losses {[r['loss'] for r in trained]} against one rank {ref}")
    # Peak device memory over the first 3 steps (no densification yet):
    # each rank against one rank, both measured from the start of their run.
    peaks = [r["stops"][0]["max_memory_allocated"] for r in trained]
    one_peak = alone["stops"][0]["max_memory_allocated"]
    # Bytes each rank's exchange moves per view, from the shapes: a record
    # is 24 float32, its depth and packed boxes 3 float64.
    rec_b, meta_b = 24 * 4, 3 * 8
    exchange = {"all_gather_bytes": d * k_loc * (rec_b + meta_b),
                "reduce_scatter_bytes": d * k_loc * rec_b,
                "routed_bytes": d * cuda_backend._round128(k_loc) * (rec_b + meta_b),
                "routed_backward_bytes": d * cuda_backend._round128(k_loc) * rec_b,
                "routed_small_bytes": d * SPLAT_XFER_SMALL * (rec_b + meta_b),
                "window_boxes_bytes": d * k_loc * 2 * 8,
                "image_rows_bytes": {name: d * max(v["strip_rows"]) * -(-W // cuda_backend.BX)
                                     * cuda_backend.BX * 10 * 4
                                     for name, v in rendered.items()}}
    emit({"phase": "splats", "card": card(), "ranks": d, "backend": "gloo on cuda:0",
          "splats": N_SPLATS, "k_loc": k_loc, "capacities": GT_CAPS,
          "ranks_seconds": ranks_s, "render": rendered, "overflow": overflow,
          "one_rank_render_seconds": one["seconds"], "exchange": exchange,
          "train_steps": SPLAT_STEPS, "loss": trained[0]["loss"], "loss_one_rank": alone["loss"],
          "rounds": rounds,
          "capacity": [s["capacity"] for s in trained[0]["stops"]],
          "rank_rows": [[s["rows"] for s in r["stops"]] for r in trained],
          "rank_state_bytes": [[s["state_bytes"] for s in r["stops"]] for r in trained],
          "one_rank_state_bytes": alone["stops"][0]["state_bytes"],
          "rank_ms_per_step": [[s["ms_per_step"] for s in r["stops"]] for r in trained],
          "one_rank_ms_per_step": alone["stops"][0]["ms_per_step"],
          "rank_max_memory_allocated": [[s["max_memory_allocated"] for s in r["stops"]]
                                        for r in trained],
          "one_rank_max_memory_allocated": [s["max_memory_allocated"] for s in alone["stops"]],
          "peak_ratio_3_steps": max(peaks) / one_peak, "one_rank_seconds": alone_s,
          "launches_per_rank": trained[0]["launches"][0],
          "scaling": "none measured: two ranks share one card",
          "seconds": time.perf_counter() - t_phase})
    return dict(launches)


def ranks_frames(name: str, got, n_messages: int, split: bool) -> dict:
    """Check one Trainer(mesh=, gui=) run of the ranks phase (both ranks'
    results) and return its figures."""
    rank0, rank1 = got
    if rank0["client_error"] is not None or rank0["client_alive"]:
        fail(f"ranks ({name}): the viewer client {rank0['client_error'] or 'hangs'}")
    replies = rank0["replies"]
    asked = sum(r["image"] for r in replies)
    if len(replies) != n_messages or rank0["items"] != network_gui.RENDER_ITEMS:
        fail(f"ranks ({name}): {len(replies)} replies to {n_messages} messages, items "
             f"{rank0['items']}")
    for k, r in enumerate(replies):
        if r["verify"] != "ranks" or r["metrics"]["#"] != rank0["num_live"] \
                or not r.get("bytes_equal", not r["image"]):
            fail(f"ranks ({name}): reply {k} {r}, the whole model's live count "
                 f"{rank0['num_live']}")
    # under tile rows rank 0 renders each frame alone; under splats every rank
    frames_want = [[VIEW_LAUNCHES] * asked, [VIEW_LAUNCHES] * (asked if split else 0)]
    for r, want in zip(got, frames_want):
        if r["frame_launches"] != want:
            fail(f"ranks ({name}): frames launched {r['frame_launches']}, want {want}")
        if r["step_launches"] != [STEP_LAUNCHES] * (RANKS_STEPS + 1):
            fail(f"ranks ({name}): steps launched {r['step_launches']}, want {STEP_LAUNCHES} "
                 "each")
        if r["idle_requests_read"]:
            fail(f"ranks ({name}): {r['idle_requests_read']} cameras read out of the words of "
                 f"{RANKS_STEPS} steps with nobody watching")
        codes = [c for _, c in r["words"]]
        if (r["step"] != RANKS_STEPS + 1 or r["served_seconds"] < RANKS_HOLD_S
                or codes.count(loop.GUI_PAUSED) < 2 or codes[-1] != loop.GUI_RESUME
                or len(r["idle_word_seconds"]) != RANKS_STEPS):
            fail(f"ranks ({name}): the pause held step {r['step']} for {r['served_seconds']} s "
                 f"with words {r['words']}; {len(r['idle_word_seconds'])} idle words")
    return {"frame_ms": rank0["frame_ms"], "served_seconds": [r["served_seconds"] for r in got],
            "words_rank1": rank1["words"], "num_live": rank0["num_live"],
            "idle_word_ms": [[1e3 * x for x in r["idle_word_seconds"]] for r in got],
            "idle_bytes": [r["idle_bytes"] for r in got],
            "frame_launches_rank1": len(rank1["frame_launches"])}


def ranks_phase(out_dir: Path, devices=None, cli_steps: int = RANKS_CLI_STEPS) -> dict:
    """The viewer over ranks and the collective probe. Two ranks sharing
    cuda:0 over gloo run Trainer(mesh=, gui=) on the 800x800 shell training
    set (131,072 splats, SH 3, the ground truth's capacities) under tile
    rows and under splat sharding, rank 0 serving a client thread of its
    own: each frame's bytes equal to the one-device frame of the same state
    through the same mode, K1 3 / K2 1 a frame on each rank that renders it
    and K1 3 / K2 1 / K3 1 a step, the pause holding both ranks' step; then
    cli.train --n_devices 2 with the viewer on and no client against
    --disable_viewer (losses within RANKS_CLI_LOSS_RTOL, step ms of each);
    then
    eval.collective_probe at both PROBE_SHAPES on PROBE_RANKS ranks sharing
    the card (K1 3 / K2 1 / K3 1 a rank and setting). Returns the launches
    of every rank's main path. With `devices` (a GPU each, NCCL) the two
    ranks run there, and the probe, whose bytes do not depend on the link,
    is left out."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    ranks_on = devices or [dev] * RANKS
    _, backend = distributed.rank_devices(RANKS, ranks_on)
    cams, model = synthetic.make_shell_training_set(W, H, N_SPLATS, views=TRAIN_VIEWS, **GT_CAPS)
    start = rehearsal.model_arrays(model)
    scene_dir = out_dir / "ranks_scene"
    shutil.rmtree(scene_dir, ignore_errors=True)
    write_colmap_scene(scene_dir, cams, model.xyz.detach().cpu().numpy(),
                       sh_to_rgb(model.features_dc.detach()[:, 0]).cpu().numpy())
    del model
    kw = dict(spatial_lr_scale=1.0, scene_extent=1.0, raster_kwargs=dict(GT_CAPS))
    n_items = len(network_gui.RENDER_ITEMS)
    messages = [rehearsal.viewer_message(cams[m % len(cams)], W, H, m, train=False)
                for m in range(n_items)]
    messages += [dict(messages[0], resolution_x=0),
                 rehearsal.viewer_message(cams[1], W, H, 0, keep_alive=False)]
    caps = [f"--{k}={v}" for k, v in GT_CAPS.items()]
    common = ["-s", str(scene_dir), "--n_devices", str(RANKS), "--resolution", "1", "--quiet",
              "--iterations", str(cli_steps), *caps]
    runs = [[*common, "-m", str(out_dir / f"ranks_{k}"),
             *(("--port", str(distributed.free_port())) if k % 2 else ("--disable_viewer",))]
            for k in range(4)]  # off, on, off, on
    t0 = time.perf_counter()
    rows, splats, cli_runs = zip(*distributed.spawn(
        rehearsal.each, RANKS,
        args=([*((rehearsal.viewer_rank, (start, cams, W, H, RANKS_STEPS,
                                          dict(kw, shard_splats=split), messages,
                                          RANKS_HEARTBEAT_S, RANKS_HOLD_S, 3))
                 for split in (False, True)),
               (rehearsal.cli_viewer_rank, (runs,))],),
        device=ranks_on, timeout_s=900))
    spawn_s = time.perf_counter() - t0
    frames = {"rows": ranks_frames("rows", rows, len(messages), False),
              "splats": ranks_frames("splats", splats, len(messages), True)}

    launches = Counter()
    for got in (*rows, *splats):
        for step in (*got["step_launches"], *got["frame_launches"]):
            launches.update(step)
    cli_report = []
    for rank, got in enumerate(cli_runs):
        loss = np.array([run["loss"] for run in got])  # (off, on, off, on) x steps
        rel = np.abs(loss - loss[0]) / np.abs(loss[0])
        if loss.shape != (4, cli_steps) or not np.all(np.isfinite(loss)) \
                or rel.max() > RANKS_CLI_LOSS_RTOL:
            fail(f"ranks: cli.train on rank {rank}: losses {loss.tolist()} (off, on, off, on), "
                 f"relative to the first run's {rel.max(axis=1).tolist()}")
        kinds = [run["viewer"] for run in got]
        if kinds != [None, "NetworkGUI" if rank == 0 else "Follower"] * 2:
            fail(f"ranks: cli.train on rank {rank} trained with viewers {kinds}")
        for run in got:
            if run["launches"] != [STEP_LAUNCHES] * cli_steps:
                fail(f"ranks: cli.train steps launched {run['launches']}, want "
                     f"{STEP_LAUNCHES} each")
            for step in run["launches"]:
                launches.update(step)
        cli_report.append({
            "loss_rel_to_first_run": rel.max(axis=1).tolist(),
            "step_ms_median": [1e3 * float(np.median(run["step_seconds"])) for run in got],
            "steps_per_s": [run["steps"] / run["train_seconds"] for run in got]})

    probes = []
    for n_log2, w in PROBE_SHAPES if devices is None else ():
        t0 = time.perf_counter()
        res = collective_probe.run(n_log2, w, PROBE_RANKS, dev)
        for s in res["settings"]:
            if not s["ranks_equal"] or s["launches"] != [STEP_LAUNCHES] * PROBE_RANKS:
                fail(f"ranks: collective_probe {n_log2} {w} {s['label']}: launches "
                     f"{s['launches']}, every rank's bytes equal: {s['ranks_equal']}")
            for got in s["launches"]:
                launches.update(got)
        probes.append({"n_log2": n_log2, "w": w, "seconds": time.perf_counter() - t0,
                       "transport": res["transport"],
                       "settings": [{k: s[k] for k in ("label", "bytes_total", "bytes", "parts",
                                                       "xfer")}
                                    for s in res["settings"]]})
    emit({"phase": "ranks", "card": card(), "ranks": RANKS,
          "backend": f"{backend} on {sorted({str(d) for d in ranks_on})}",
          "splats": N_SPLATS, "capacities": GT_CAPS, "spawn_seconds": spawn_s,
          "heartbeat_s": RANKS_HEARTBEAT_S, "hold_s": RANKS_HOLD_S, "frames": frames,
          "cli": cli_report, "cli_steps": cli_steps,
          "cli_loss": [r[0]["loss"] for r in cli_runs], "probe": probes,
          "scaling": "none measured: ranks share one card",
          "seconds": time.perf_counter() - t_phase})
    return dict(launches)


def step_loss(out):
    return out[2]["loss"]  # train_step's metrics


def check_calls(what: str, log: list, want: dict) -> None:
    off = [i for i, (got, _) in enumerate(log, 1) if got != want]
    if not log or off:
        fail(f"{what}: {len(log)} calls, {len(off)} of them not {want} "
             f"(first: {[log[i - 1][0] for i in off[:3]]})")


def finite_losses(what: str, log: list) -> list[float]:
    losses = torch.stack([loss for _, loss in log]).tolist()
    if not all(math.isfinite(v) for v in losses):
        fail(f"{what}: a non-finite loss among {len(losses)} steps")
    return losses


def capk_against_plain() -> dict:
    """K2 and K3 on the bench lists zero-padded to capk_probe's largest
    capacity (tiles past 2048 entries walk zero records) against their
    plain versions, at the kernels' standing tolerances."""
    rec3, raw, nty = capk_probe.lists(torch.device("cuda"))
    capk = capk_probe.CAPKS[-1]
    r3 = capk_probe.at_capk(rec3, capk)
    counts = torch.clamp(raw, max=capk).to(torch.int32)
    out, rows, args = capk_probe.blend_both(r3, counts, nty)
    ref = cuda_backend.blend_tiles_plain(r3, counts, nty)
    ref_rows = cuda_backend.blend_tiles_backward_plain(*args)[:rows.shape[0]]
    torch.cuda.synchronize()
    err = float((out[:, :12] - ref[:, :12]).abs().max())
    flips = float((out[:, 12] != ref[:, 12]).to(torch.float32).mean())
    row_scale = ref_rows[:, :19].abs().amax(dim=1).clamp(min=1e-30)
    row_err = float(((rows[:, :19] - ref_rows[:, :19]).abs().amax(dim=1) / row_scale).max())
    finite = bool(torch.isfinite(out).all()) and bool(torch.isfinite(rows).all())
    if not (finite and err <= KERNEL_TOL and flips <= LAST_FLIP_FRAC and row_err <= BWD_ROW_TOL
            and torch.equal(rows[:, 19], ref_rows[:, 19])):
        fail(f"capk {capk}: finite {finite}; K2 vs plain max|d| {err} (tol {KERNEL_TOL}), "
             f"last-contributor flips {flips} (tol {LAST_FLIP_FRAC}); K3 row error {row_err} "
             f"(tol {BWD_ROW_TOL}), slot column equal "
             f"{torch.equal(rows[:, 19], ref_rows[:, 19])}")
    return {"capk": capk, "tiles_past_base": int((raw > rec3.shape[2]).sum()),
            "k2_max_abs_err": err, "k2_last_flip_frac": flips, "k3_rows": rows.shape[0],
            "k3_row_rel_err": row_err}


def scripts_phase() -> dict:
    """The JAX repo's scripts as the port's entry points, each called as a
    function at its defaults (the soak cut to SOAK_STEPS steps), with
    their launches counted: K1 3 / K2 1 / K3 1 a training step and K1 3 /
    K2 1 a render. Returns the phase's launches; the kernels' comparisons
    with their plain versions are not among them."""
    t_phase = time.perf_counter()
    launches = Counter()
    seconds = {}

    def counted(name, fn):
        native.LAUNCHES.clear()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        launches.update(native.LAUNCHES)
        return out, dict(native.LAUNCHES)

    steps = []
    with rehearsal.per_call(loop, "train_step", steps, step_loss):
        bench, got = counted("train_bench", train_bench.run)
    check_calls("train_bench steps", steps, STEP_LAUNCHES)
    finite_losses("train_bench", steps)
    if got != {k: v * len(steps) for k, v in STEP_LAUNCHES.items()}:
        fail(f"train_bench: {len(steps)} steps launched {got}")
    emit({"phase": "scripts", "script": "train_bench", "steps": len(steps), **bench,
          "seconds": seconds["train_bench"]})

    steps, views = [], []
    with rehearsal.per_call(loop, "train_step", steps, step_loss), \
            rehearsal.per_call(loop.Trainer, "render_view", views):
        (soak, trainer), got = counted("soak_train", lambda: soak_train.run(SOAK_STEPS, W))
    check_calls("soak_train steps", steps, STEP_LAUNCHES)
    check_calls("soak_train evaluation renders", views, VIEW_LAUNCHES)
    losses = finite_losses("soak_train", steps)
    renders = len(views) + soak_train.VIEWS  # and the ground truth's
    want = {k: STEP_LAUNCHES[k] * len(steps) + VIEW_LAUNCHES.get(k, 0) * renders
            for k in STEP_LAUNCHES}
    if got != want or len(steps) != SOAK_STEPS:
        fail(f"soak_train: {len(steps)} steps and {renders} renders launched {got}, want {want}")
    if not soak["psnr4_end"] > soak["psnr4_start"]:
        fail(f"soak_train: PSNR over 4 views went from {soak['psnr4_start']} to "
             f"{soak['psnr4_end']}")
    for name, a in [*trainer.model.params._asdict().items(),
                    *((f"mu.{k}", v) for k, v in trainer.adam.mu._asdict().items()),
                    *((f"nu.{k}", v) for k, v in trainer.adam.nu._asdict().items())]:
        if not bool(torch.isfinite(a).all()):
            fail(f"soak_train: non-finite {name}")
    del trainer
    emit({"phase": "scripts", "script": "soak_train", **soak, "loss_first": losses[0],
          "loss_last": losses[-1], "evaluation_renders": len(views),
          "cut": f"{SOAK_STEPS} steps of the script's 3000 (the phase's time); width, "
                 "scene and schedule the script's", "seconds": seconds["soak_train"]})

    fidelity, got = counted("fidelity_probe", fidelity_probe.run)
    renders = 2 * (2 + len(fidelity_probe.TILE_CAPS))
    if got != {k: v * renders for k, v in VIEW_LAUNCHES.items()}:
        fail(f"fidelity_probe: {renders} renders launched {got}")
    emit({"phase": "scripts", "script": "fidelity_probe", **fidelity,
          "seconds": seconds["fidelity_probe"]})

    capk, got = counted("capk_probe", capk_probe.run)
    plain = capk_against_plain()
    emit({"phase": "scripts", "script": "capk_probe", **capk, "against_plain": plain,
          "launches": got, "seconds": seconds["capk_probe"]})

    loss, _ = counted("loss_probe", loss_probe.run)
    emit({"phase": "scripts", "script": "loss_probe", **loss, "seconds": seconds["loss_probe"]})

    balance, got = counted("strip_balance_probe", strip_balance_probe.run)
    if got != {"select_values": 3 * 2}:
        fail(f"strip_balance_probe: two scenes' binning launched {got}")
    emit({"phase": "scripts", "script": "strip_balance_probe", **balance,
          "seconds": seconds["strip_balance_probe"]})
    emit({"phase": "scripts", "launches": dict(launches), "seconds": seconds,
          "total_seconds": time.perf_counter() - t_phase})
    return dict(launches)


def summary_check(out_dir: Path, model_dir: Path, results: dict) -> None:
    """eval.summary on the directory that holds the cli phase's model: its
    row of the model holds the PSNR and SSIM cli.metrics wrote."""
    rows = summary.main(["-o", str(out_dir)])
    row = rows.get(model_dir.name, {})
    if (row.get("PSNR"), row.get("SSIM")) != (results["PSNR"], results["SSIM"]):
        fail(f"summary: the model's row {row} lacks cli.metrics' {results}")
    emit({"phase": "scripts", "script": "summary", "rows": rows})


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
    sms, select_per_sm = select_kernel.kernel_occupancy(torch.device("cuda"))
    _, count_per_sm = select_kernel.count_occupancy(torch.device("cuda"))
    count_sass = sass_item_instructions("select_counts")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "knn_build_seconds": knn_build_s,
          "libraries": [native.library_path(n).name for n in native.SOURCES],
          "ptxas": ptxas, "blend_occupancy": occupancy,
          "select_occupancy": {"sms": sms, "ctas_per_sm": select_per_sm},
          "count_occupancy": {"sms": sms, "ctas_per_sm": count_per_sm},
          "count_item_loop_instructions": count_sass})

    if sys.argv[1:] == ["rows"]:
        rows_phase()  # `python3 chip_smoke.py rows`: build and the rows phase, no verdict
        return
    if sys.argv[1:] == ["splats"]:
        splats_phase()  # `python3 chip_smoke.py splats`: build and the splats phase, no verdict
        return
    out_dir = Path(__file__).resolve().parent / ".smoke"
    out_dir.mkdir(exist_ok=True)
    if sys.argv[1:] == ["ranks"]:
        ranks_phase(out_dir)  # `python3 chip_smoke.py ranks`: build and the ranks phase, no verdict
        return
    if sys.argv[1:] == ["ranks_nccl"]:  # the same on cuda:0 and cuda:1 over NCCL, no probe
        ranks_phase(out_dir, [torch.device("cuda", r) for r in range(RANKS)],
                    RANKS_NCCL_CLI_STEPS)
        return
    if sys.argv[1:] == ["viewer"]:
        cli(out_dir, mesh_fn=None)  # the cli phase and the viewer phase on its model, no verdict
        return
    if sys.argv[1:] == ["scripts"]:
        cli(out_dir, mesh_fn=None)  # its model for eval.summary, then the scripts phase
        scripts_phase()
        return
    if sys.argv[1:] == ["mesh_depth"]:  # the cli phase, then its bounded mesh four ways, no verdict
        cli(out_dir, mesh_fn=mesh_depth, with_viewer=False)
        return
    settings = api.RasterSettings(W, H, **CAPS)
    bench, selects, (rec3, counts, nty) = bench_inputs(settings)
    levels, level_counts = zip(*(select_level(lv, k)
                                 for lv, (_, k) in zip(("L1", "L2", "L3"), selects)))
    count_levels = [count_level(lv, selects[i][1], level_counts[i], count_sass)
                    for i, lv in ((1, "L2"), (2, "L3"))]
    reduce_infos = reduce_check()
    blend = blend_check(rec3, counts, nty)
    bwd = backward_check(rec3, counts, nty)
    if sys.argv[1:] == ["kernels"]:
        return  # `python3 chip_smoke.py kernels`: build and kernel checks only, no verdict

    t0 = time.perf_counter()
    probe_launches = probes()
    probe_s = time.perf_counter() - t0

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
    rows_launches, blend_row0, bwd_row0 = rows_phase()
    rows_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    splat_launches = splats_phase()
    splats_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rank_launches = ranks_phase(out_dir)
    ranks_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli_launches, mesh_s, viewer_s = cli(out_dir)
    cli_s = time.perf_counter() - t0 - mesh_s - viewer_s
    t0 = time.perf_counter()
    backend_launches = backends()
    backends_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gate_launches = quality_gate_phase(out_dir)
    gate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    script_launches = scripts_phase()
    scripts_s = time.perf_counter() - t0
    emit({"phase": "seconds", "probe": probe_s, "serve": serve_s, "train": train_s,
          "rows": rows_s, "splats": splats_s, "ranks": ranks_s, "cli": cli_s, "mesh": mesh_s,
          "viewer": viewer_s, "backends": backends_s, "quality_gate": gate_s, "scripts": scripts_s,
          "total": time.perf_counter() - t_start})

    def launched(name):  # cli_launches holds the mesh and viewer phases'
        return sum(ph.get(name, 0) for ph in (probe_launches, launches, train_launches,
                                              rows_launches, splat_launches, rank_launches,
                                              cli_launches,
                                              backend_launches, gate_launches, script_launches))

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
         "alone_ms": {lv["level"]: lv["kernel_ms"] for lv in levels},
         "grid": {lv["level"]: {k: lv[k] for k in ("items", "ctas", "chunk")}
                  for lv in levels},
         "occupancy": {"ctas_per_sm": select_per_sm, "sms": sms},
         "ptxas": ptxas["select_values"],
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
         "row0": {k: blend_row0[k] for k in ("row0", "tiles", "max_abs_err", "ms",
                                              "bound_ms", "bound_by")},
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
         "row0": {k: bwd_row0[k] for k in ("row0", "tiles", "max_abs_err", "ms",
                                            "bound_ms", "bound_by")},
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
         "alone_ms": {lv["level"]: lv["kernel_ms"] for lv in count_levels},
         "issue_floor_ms": {lv["level"]: lv["issue_floor_ms"] for lv in count_levels},
         "grid": {lv["level"]: {k: lv[k] for k in ("items", "walked_items", "ctas",
                                                    "walked_items_per_cta_max")}
                  for lv in count_levels},
         "occupancy": {"ctas_per_sm": count_per_sm, "sms": sms},
         "ptxas": ptxas["select_counts"],
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
           "library_ms": None,
           "dynamic_smem_bytes": reduce_infos[name]["dynamic_smem_bytes"],
           "ptxas": reduce_infos[name]["ptxas"]}
          for name, line, tpu in (("reduce_probe_shuffle", 44, "kernel_vpu"),
                                  ("reduce_probe_mma", 56, "kernel_mxu"))),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
