"""Training: one step as a function, and the host-side orchestration
(port of tpu2dgs/train/loop.py).

  * `train_step`: render -> loss -> backward -> Adam -> densification
    statistics, for one view or a batch of views. The loss-term gates
    (normal loss and distortion loss switch on at set iterations) enter as
    plain scalars.
  * `Trainer`: the host loop: camera shuffling, the spherical-harmonics
    warm-up, densification, opacity resets, capacity growth, adaptive
    growth of the rasterizer's capacities from its overflow counters, a
    rolling Mpix/s counter, and with a viewer (`gui`, one device only) the
    frames its client asks for between steps (K1 three times, K2 once a
    frame on the cuda backend).

On the cuda backend the step launches the select kernel three times and
the forward and the backward blend kernel once each per view; the tiled
and oracle backends train through plain PyTorch autograd, and the tiled
backend's overflow counters heal its caps the same way. Nothing in the
step reads a value back to the host: the loss is read every
`loss_sync_interval` steps (every step while a viewer client is connected)
and the overflow counters once per densification interval, so the host
keeps enqueueing ahead of the device.

Densification gradients: the gradient with respect to the `mean2d_offset`
argument of render, converted from pixel units to NDC half-extent units
(times 0.5 * W, 0.5 * H) so the reference's 2e-4 threshold carries over.

With a `mesh` (parallel/distributed.py) the Trainer runs on every rank of
it, one process per device, and each renders its tile rows of every view
(parallel/sharded.py). Every rank keeps the same parameters and Adam state:
the same seeds and generators, the same camera order, and gradients summed
over the ranks inside render, so the view-space gradients and radii that
densification reads, and the overflow counters (the worst strip's) that
capacity growth reads, are the same on every rank, and every rank clones,
splits, prunes and grows alike.

With `shard_splats=True` as well (the cuda backend), each rank keeps its
own segment of the capacity axis: the parameters, the Adam moments and
the densification statistics, 1/D of each (parallel/sharded.py). A step
renders with the splats sharded and runs Adam and the statistics on the
rank's rows. A densification round runs on the rank's segment alone, with
its columns of split noise drawn for the whole capacity from the
generator every rank shares: segment d of densify_and_prune(segments=D)
of the whole model. The live and dropped counts that decide growth are
summed over the ranks, and growth pads each segment at its end.
`whole_state` gathers the whole model into rank 0's host memory, for
saving; `render_view` renders from the segments, every rank together.
"""

from __future__ import annotations

import dataclasses
import os
import select
import time
from typing import Callable, Optional

import numpy as np
import torch

from tpu2dgs_torch.core.cameras import Camera
from tpu2dgs_torch.model import densify as densify_lib
from tpu2dgs_torch.model import optim as optim_lib
from tpu2dgs_torch.model import splats as splats_lib
from tpu2dgs_torch.parallel import distributed, sharded
from tpu2dgs_torch.parallel.distributed import Mesh
from tpu2dgs_torch.raster.api import RasterSettings, render
from tpu2dgs_torch.raster.cuda_backend import BX, _round_group
from tpu2dgs_torch.train import losses

# Backend capacity-overflow diagnostics (api.render output keys) and the
# RasterSettings knob each one is healed by. The xfer keys belong to the
# multi-device splat exchange and appear only when a backend reports them.
OVERFLOW_KEYS = ("tile_overflow_frac", "bin_overflow_frac",
                 "col_overflow_frac", "grad_pack_overflow_frac",
                 "vis_overflow", "tile_count_max", "bin_count_max",
                 "col_count_max", "grad_pack_max",
                 "xfer_overflow_frac", "xfer_count_max")
OVERFLOW_CAP_OF = {
    "tile_overflow_frac": "tile_capacity",
    "bin_overflow_frac": "bin_capacity",
    "col_overflow_frac": "col_capacity",
    "grad_pack_overflow_frac": "grad_pack_capacity",
    "xfer_overflow_frac": "xfer_capacity",
}
# True demand maxima reported by the backend: growth sizes the new cap
# directly from these instead of climbing a 1.5x ladder.
OVERFLOW_DEMAND_OF = {
    "tile_overflow_frac": "tile_count_max",
    "bin_overflow_frac": "bin_count_max",
    "col_overflow_frac": "col_count_max",
    "grad_pack_overflow_frac": "grad_pack_max",
    "xfer_overflow_frac": "xfer_count_max",
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization defaults of record (the reference's arguments and
    schedule constants)."""

    iterations: int = 30_000
    lambda_dssim: float = 0.2
    lambda_dist: float = 0.0
    lambda_normal: float = 0.05
    normal_from_iter: int = 7_000
    dist_from_iter: int = 3_000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densification_interval: int = 100
    opacity_reset_interval: int = 3_000
    sh_increment_interval: int = 1_000
    grad_threshold: float = 2e-4
    percent_dense: float = 0.01
    opacity_cull: float = 0.05
    random_background: bool = False
    grow_watermark: float = 0.9   # grow capacity when live/capacity exceeds
    camera_batch: int = 1         # views per step (batched SGD)
    loss_sync_interval: int = 10  # read the loss on the host every N steps:
                                  # a read per step would make the host wait
                                  # for the device each step


def view_gradients(model, settings, cam, gt, bg, lambda_dssim, lam_normal, lam_dist,
                   plain: bool = False, mesh=None, shard_splats: bool = False):
    """The training loss of one view and its gradients: (loss, (radii, l1,
    normal loss, distortion loss, overflow dict), gradients as SplatParams,
    gradient of the screen-space offset (C,2)). `plain=True` goes through
    the kernels' plain versions; with `mesh`, the view's tile rows are
    split over the mesh's ranks, and with `shard_splats` the splats too:
    `model` is this rank's segment."""
    p = model.params
    offset = torch.zeros((model.capacity, 2), dtype=torch.float32,
                         device=p.xyz.device, requires_grad=True)
    out = render(
        cam, settings,
        p.xyz,
        torch.exp(p.scaling),
        p.rotation,
        torch.sigmoid(p.opacity[:, 0]),
        splats_lib.features(p),
        bg,
        mean2d_offset=offset,
        live=model.live,
        mesh=mesh,
        shard_splats=shard_splats,
        device=p.xyz.device,
        plain=plain,
    )
    photo, ll1 = losses.photometric_loss(out["render"], gt, lambda_dssim)
    ln = losses.normal_consistency_loss(out["rend_normal"], out["surf_normal"])
    ld = losses.distortion_loss(out["rend_dist"])
    total = photo + lam_normal * ln + lam_dist * ld
    # Every capacity-overflow diagnostic the backend reports rides along, so
    # the Trainer can close the loop (adaptive cap growth).
    overflow = {k: out[k].detach().to(torch.float32) for k in OVERFLOW_KEYS if k in out}
    grads = torch.autograd.grad(total, [*p, offset])
    aux = (out["radii"], ll1.detach(), ln.detach(), ld.detach(), overflow)
    return total.detach(), aux, splats_lib.SplatParams(*grads[:-1]), grads[-1]


def train_step(settings: RasterSettings, opt_cfg: optim_lib.OptimConfig,
               lambda_dssim: float, spatial_lr_scale: float,
               model: splats_lib.SplatModel, adam: optim_lib.AdamState,
               cams, gts, bg, step, lam_normal: float, lam_dist: float, mesh=None,
               shard_splats: bool = False):
    """One optimization step on the views `cams` (a list of CameraArrays)
    with ground truths `gts`. Updates `model` and `adam` in place and
    returns (model, adam, metrics); the metrics are tensors on the device.

    With several views the loss and the gradients are the mean over the
    views, the radii their maximum; the demand maxima among the overflow
    counters (*_max) reduce with the maximum, the fractions with the
    mean. With `mesh`, each view's tile rows are split over its ranks, and
    with `shard_splats` the splats: `model` and `adam` are this rank's
    segment, and num_visible is summed over the ranks."""
    n = len(cams)
    per_view = [view_gradients(model, settings, cam, gt, bg, lambda_dssim, lam_normal,
                               lam_dist, mesh=mesh, shard_splats=shard_splats)
                for cam, gt in zip(cams, gts)]
    if n == 1:
        loss, (radii, ll1, ln, ld, overflow), gparams, goffset = per_view[0]
    else:
        def mean(xs):
            return torch.mean(torch.stack(list(xs)), dim=0)

        loss = mean(v[0] for v in per_view)
        auxes = [v[1] for v in per_view]
        radii = torch.amax(torch.stack([a[0] for a in auxes]), dim=0)
        ll1, ln, ld = (mean(a[i] for a in auxes) for i in (1, 2, 3))
        overflow = {
            k: (torch.amax if k.endswith("_max") else torch.mean)(
                torch.stack([a[4][k] for a in auxes]), dim=0)
            for k in auxes[0][4]}
        gparams = splats_lib.SplatParams(*(mean(gs) for gs in zip(*(v[2] for v in per_view))))
        goffset = mean(v[3] for v in per_view)

    lrs = optim_lib.learning_rates(opt_cfg, step, spatial_lr_scale)
    _, adam = optim_lib.adam_step(opt_cfg, model.params, gparams, adam, lrs, model.live)
    half = goffset.new_tensor([settings.width * 0.5, settings.height * 0.5])
    densify_lib.add_stats(model, goffset * half[None, :], radii)

    num_visible = torch.sum(radii > 0)
    if shard_splats:
        num_visible = distributed.all_reduce(mesh, num_visible)
    metrics = {
        "loss": loss, "l1": ll1, "normal": ln, "dist": ld,
        "num_visible": num_visible,
        **overflow,
    }
    return model, adam, metrics


def grow_with_adam(model, adam: optim_lib.AdamState, new_capacity: int, segments: int = 1):
    """Capacity growth: pad the parameters, the statistics and the Adam
    moments with dead rows, spread over `segments` blocks as
    splats.grow_capacity spreads them."""
    model = splats_lib.grow_capacity(model, new_capacity, segments=segments)

    def pad(a):
        return splats_lib.pad_segments(a, new_capacity, segments)

    adam = optim_lib.AdamState(
        count=adam.count,
        mu=splats_lib.SplatParams(*(pad(a) for a in adam.mu)),
        nu=splats_lib.SplatParams(*(pad(a) for a in adam.nu)),
    )
    return model, adam


class Trainer:
    """Host-side training orchestration."""

    def __init__(
        self,
        model: splats_lib.SplatModel,
        cameras: list[Camera],
        width: int,
        height: int,
        spatial_lr_scale: float,
        scene_extent: float,
        train_cfg: TrainConfig = TrainConfig(),
        opt_cfg: optim_lib.OptimConfig = optim_lib.OptimConfig(),
        raster_kwargs: Optional[dict] = None,
        white_background: bool = False,
        max_sh_degree: int = 3,
        seed: int = 0,
        log_fn: Optional[Callable[[int, dict], None]] = None,
        max_capacity: int = 4_194_304,
        mesh=None,
        shard_splats: bool = False,
        profile_dir: str | None = None,
        profile_steps: tuple[int, int] = (100, 110),
        max_caps: Optional[dict] = None,
        gui=None,
        gt_cache_mb: Optional[float] = None,
    ):
        # Without a mesh the flag is ignored, as in the JAX package.
        self.shard_splats = shard_splats and mesh is not None
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.distributed.Mesh, not {type(mesh)!r}")
            host = self.shard_splats and model.xyz.device.type == "cpu"
            if mesh.device != model.xyz.device and not host:
                raise ValueError(f"the model is on {model.xyz.device}, the mesh's rank on "
                                 f"{mesh.device}")
        self.mesh = mesh
        self.gui = gui             # a viewer.network_gui.NetworkGUI, polled every step
        self._gui_paused = False   # the client sent do_training=False
        self.source_path = ""      # the verify string sent to the viewer
        self.max_capacity = max_capacity
        if self.shard_splats:
            # This rank's segment of the model (whole, on the rank's device
            # or in host memory) and fresh Adam moments for it: the Trainer
            # keeps no reference to the whole model.
            self.model, self.adam = sharded.shard_model_state(model, None, mesh)
        else:
            self.model, self.adam = model, optim_lib.init_adam(model.params)
        self.device = self.model.xyz.device
        self.cameras = cameras
        self.width, self.height = width, height
        self.spatial_lr_scale = spatial_lr_scale
        self.scene_extent = scene_extent
        self.cfg = train_cfg
        self.opt_cfg = opt_cfg
        self.raster_kwargs = dict(raster_kwargs or {})
        self.white_background = white_background
        self.max_sh_degree = max_sh_degree
        self.active_sh_degree = 0
        self.rng = np.random.default_rng(seed)  # camera order: as the JAX Trainer
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.log_fn = log_fn
        # torch.profiler trace of steps [a, b) when set, written to
        # profile_dir as a Chrome trace, and a rolling Mpix/s counter.
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self._profiler = None
        self.mpix_s = 0.0
        self.step = 0
        self.ema_loss = 0.0
        self._cam_stack: list[int] = []
        self.densify_cfg = densify_lib.DensifyConfig(
            grad_threshold=train_cfg.grad_threshold,
            percent_dense=train_cfg.percent_dense,
            opacity_cull=train_cfg.opacity_cull,
        )
        self.bg = (torch.ones if white_background else torch.zeros)(
            3, dtype=torch.float32, device=self.device)
        # Adaptive capacity caps: any nonzero overflow fraction seen at a
        # densification boundary raises the corresponding cap before the
        # next step, so a scene whose depth complexity exceeds the
        # configured caps heals itself instead of truncating its lists
        # until someone reads the counters. The growth ceilings are the
        # JAX package's, kept so both packages heal alike.
        self.max_caps = {
            "tile_capacity": 16_384, "bin_capacity": 20_480,
            "col_capacity": 61_440, "grad_pack_capacity": 1 << 22,
            "xfer_capacity": 262_144,
            **(max_caps or {}),
        }
        self.cap_growth_events: list[tuple[int, str, int]] = []
        self.last_densify: Optional[densify_lib.DensifyInfo] = None
        self._cam_arrays = [c.arrays(self.device) for c in cameras]
        # Ground-truth images: staged on the device once when they fit the
        # budget `gt_cache_mb` (None: no budget). A set over the budget
        # stays on the host, in pinned memory where there is a GPU, and the
        # views the camera shuffle will ask for next are copied ahead on a
        # side stream while the current step computes: device memory for a
        # few images whatever the size of the set.
        host = [None if c.image is None
                else torch.from_numpy(np.ascontiguousarray(c.image, np.float32))
                for c in cameras]
        total_mb = sum(im.numel() * 4 / 1e6 for im in host if im is not None)
        self.gt_prestaged = gt_cache_mb is None or total_mb <= gt_cache_mb
        if self.gt_prestaged:
            self._gt_images = [None if im is None else im.to(self.device) for im in host]
        else:
            cuda = self.device.type == "cuda"
            self._gt_host = [im.pin_memory() if cuda and im is not None else im
                             for im in host]
            self._gt_stream = torch.cuda.Stream(self.device) if cuda else None
            # view index -> (image on the device, event of its copy or None)
            self._gt_prefetch: dict[int, tuple] = {}

    # -- helpers -----------------------------------------------------------

    @property
    def gui(self):
        return self._gui

    @gui.setter
    def gui(self, gui) -> None:
        if gui is not None and self.mesh is not None:
            # A frame would be a render every rank joins, and under splat
            # sharding a rank holds only its segment of the model.
            raise NotImplementedError(
                "the viewer under a mesh is a later slice of the port: train with one "
                "device, or without the viewer")
        self._gui = gui

    def _settings(self) -> RasterSettings:
        return RasterSettings(
            width=self.width, height=self.height,
            sh_degree=self.active_sh_degree, **self.raster_kwargs,
        )

    def _next_camera_index(self) -> int:
        if not self._cam_stack:
            self._cam_stack = list(self.rng.permutation(len(self.cameras)))
        return int(self._cam_stack.pop())

    def _peek_camera_indices(self, k: int) -> list[int]:
        """The next up-to-k indices _next_camera_index will return
        (refilling the shuffled stack if empty): the prefetch targets.
        Looks only within the current epoch's stack: the next epoch's
        permutation is not drawn early."""
        if not self._cam_stack:
            self._cam_stack = list(self.rng.permutation(len(self.cameras)))
        return [int(x) for x in self._cam_stack[-k:][::-1]]

    def _upload_gt(self, ci: int) -> tuple:
        """Start the copy of view ci's ground truth to the device: on the
        side stream where there is one, so it overlaps the compute."""
        im = self._gt_host[ci]
        if im is None or self._gt_stream is None:
            return (None if im is None else im.to(self.device)), None
        with torch.cuda.stream(self._gt_stream):
            arr = im.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._gt_stream)
        return arr, done

    def _gt_for(self, ci: int):
        """Ground truth of view ci on the device. Under a gt_cache_mb
        budget: take the copy made ahead (or upload now on a miss), make
        the computing stream wait for it, and start the copies of the
        upcoming views, the whole next batch when camera_batch > 1."""
        if self.gt_prestaged:
            return self._gt_images[ci]
        hit = self._gt_prefetch.pop(ci, None)
        arr, done = hit if hit is not None else self._upload_gt(ci)
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)         # no read before the copy has landed
            arr.record_stream(cur)       # nor reuse of its memory before the read
        depth = max(3, self.cfg.camera_batch)
        for nxt in self._peek_camera_indices(depth):
            if len(self._gt_prefetch) >= depth:
                break
            if nxt not in self._gt_prefetch:
                self._gt_prefetch[nxt] = self._upload_gt(nxt)
        return arr

    def _segments(self) -> int:
        """The segments of the capacity axis: one a rank under splat
        sharding, else one."""
        return self.mesh.size if self.shard_splats else 1

    def capacity(self) -> int:
        """The whole model's capacity (each rank holds 1/D of it under splat
        sharding)."""
        return self.model.capacity * self._segments()

    def whole_state(self):
        """(model, adam), whole: under splat sharding gathered from every
        rank's segment into rank 0's host memory, (None, None) on the other
        ranks (a collective: every rank calls it); else the Trainer's own."""
        if self.shard_splats:
            return sharded.gather_model_state(self.model, self.adam, self.mesh)
        return self.model, self.adam

    def _densify_round(self, eps: torch.Tensor, use_size_prune: bool):
        """One densification round on this rank's model. `eps` is the split
        noise of the whole capacity; under splat sharding the rank takes its
        segment's columns, so the round is segment `rank` of
        densify_and_prune(segments=D) of the whole model."""
        if self.shard_splats:
            c = self.model.capacity
            eps = eps[:, self.mesh.rank * c:(self.mesh.rank + 1) * c]
        return densify_lib.densify_and_prune(
            self.densify_cfg, self.model, self.adam, None, float(self.scene_extent),
            use_size_prune, eps=eps)

    def _current_cap(self, kwarg: str) -> int:
        val = self.raster_kwargs.get(kwarg)
        if val is None:
            val = getattr(RasterSettings, kwarg)  # dataclass field default
        if (kwarg == "grad_pack_capacity" and not val
                and self.raster_kwargs.get("backend", "cuda") == "cuda"):
            # 0 = derived default: 16 * group-rounded tile capacity * image
            # tile columns, an upper bound of the cuda backend's own
            # derivation (cuda_backend.blend_binned); the plain backends pack
            # no gradient rows
            tc = self._current_cap("tile_capacity")
            val = 16 * _round_group(tc) * (-(-self.width // BX))
        return int(val)

    def _maybe_grow_caps(self, it: int, metrics: dict) -> None:
        """Close the capacity-overflow loop: any nonzero overflow fraction
        raises its cap to the reported demand plus 25%, at least 1.5x
        (128-rounded), up to the ceiling. Reads the counters back to the
        host: called only at cadence boundaries."""
        for key, kwarg in OVERFLOW_CAP_OF.items():
            v = metrics.get(key)
            if v is None or float(v) <= 0.0:
                continue
            cur = self._current_cap(kwarg)
            demand = metrics.get(OVERFLOW_DEMAND_OF[key])
            want = int(float(demand) * 1.25) if demand is not None else int(cur * 1.5)
            new = min(-(-max(want, int(cur * 1.5)) // 128) * 128, self.max_caps[kwarg])
            if new > cur:
                self.raster_kwargs[kwarg] = new
                self.cap_growth_events.append((it, kwarg, new))

    def _profile(self, it: int) -> None:
        if it == self.profile_steps[0] and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities)
            self._profiler.start()
        elif it == self.profile_steps[1]:
            self._stop_profile()

    def _stop_profile(self) -> None:
        if self._profiler is not None:
            self._profiler.stop()
            os.makedirs(self.profile_dir, exist_ok=True)
            self._profiler.export_chrome_trace(
                os.path.join(self.profile_dir, f"train_steps_{self.profile_steps[0]}.json"))
            self._profiler = None

    # -- the loop ----------------------------------------------------------

    def train(self, num_iters: Optional[int] = None, progress: bool = False):
        end = self.step + (num_iters or self.cfg.iterations)
        t0 = time.perf_counter()
        t_win, it_win = t0, self.step  # rolling Mpix/s window
        cfg = self.cfg
        while self.step < end:
            self.step += 1
            it = self.step

            if self.profile_dir is not None:
                self._profile(it)

            # SH degree warm-up: one level every sh_increment_interval steps.
            if it % cfg.sh_increment_interval == 0 and self.active_sh_degree < self.max_sh_degree:
                self.active_sh_degree += 1

            idxs = [self._next_camera_index() for _ in range(cfg.camera_batch)]
            bg = (torch.rand(3, device=self.device, generator=self.generator)
                  if cfg.random_background else self.bg)
            lam_n = cfg.lambda_normal if it > cfg.normal_from_iter else 0.0
            lam_d = cfg.lambda_dist if it > cfg.dist_from_iter else 0.0

            self.model, self.adam, metrics = train_step(
                self._settings(), self.opt_cfg, cfg.lambda_dssim, self.spatial_lr_scale,
                self.model, self.adam, [self._cam_arrays[i] for i in idxs],
                [self._gt_for(i) for i in idxs], bg, float(it), lam_n, lam_d, self.mesh,
                self.shard_splats)

            # Adaptive cap growth: consume the overflow counters at the
            # densification cadence (one host sync per interval).
            if it % cfg.densification_interval == 0:
                self._maybe_grow_caps(it, metrics)

            # Densify / prune / opacity reset.
            if it < cfg.densify_until_iter:
                if it > cfg.densify_from_iter and it % cfg.densification_interval == 0:
                    eps = torch.randn((self.densify_cfg.split_n, self.capacity(), 2),
                                      device=self.device, generator=self.generator)
                    self.model, self.adam, info = self._densify_round(
                        eps, it > cfg.opacity_reset_interval)
                    if self.shard_splats:  # every rank decides growth alike
                        info = densify_lib.DensifyInfo(*distributed.all_reduce(
                            self.mesh, torch.stack(list(info))).unbind())
                    self.last_densify = info
                    # Children dropped for lack of free slots are capacity
                    # pressure too: under splat sharding a full segment
                    # drops them below the watermark.
                    cap = self.capacity()
                    if ((int(info.num_live) > cfg.grow_watermark * cap
                         or int(info.num_dropped) > 0) and cap < self.max_capacity):
                        new_cap = min(splats_lib.round_capacity(2 * cap), self.max_capacity)
                        # a rank's segment gains its share of the new rows
                        self.model, self.adam = grow_with_adam(
                            self.model, self.adam,
                            self.model.capacity + (new_cap - cap) // self._segments())
                if it % cfg.opacity_reset_interval == 0 or (
                        self.white_background and it == cfg.densify_from_iter):
                    densify_lib.reset_opacity(self.model, self.adam)

            if it % 50 == 0:
                # rolling Mpix/s (rasterized pixels per second of host time)
                now = time.perf_counter()
                px = (it - it_win) * self.width * self.height * cfg.camera_batch
                self.mpix_s = px / max(now - t_win, 1e-9) / 1e6
                t_win, it_win = now, it
                metrics = dict(metrics)
                metrics["mpix_per_s"] = self.mpix_s
            if self.log_fn is not None:
                self.log_fn(it, metrics)
            if self.gui is not None and self.gui.conn is None:
                self.gui.try_connect()  # a client waiting: no wait if none is
            viewed = self.gui is not None and self.gui.conn is not None
            # The loss EMA is for display: read it now and then, so the
            # host does not wait for the device every step; every step
            # while a viewer client is connected, which shows it.
            if it % cfg.loss_sync_interval == 0 or it == end or viewed:
                self.ema_loss = 0.4 * float(metrics["loss"]) + 0.6 * self.ema_loss
            if viewed:
                self._poll_gui(it, end)
            if progress and it % 200 == 0:
                dt = time.perf_counter() - t0
                own = " on this rank" if self.shard_splats else ""
                print(f"[{it}] loss={self.ema_loss:.4f} live={int(self.model.num_live())}{own} "
                      f"({it / dt:.1f} it/s, {self.mpix_s:.2f} Mpix/s)", flush=True)
        self._stop_profile()  # training ended inside the profile window
        return self.model

    def _poll_gui(self, it: int, end: int) -> None:
        """Serve the connected viewer's pending requests between steps
        (reference train.py:146-168): a frame of the model as it is, then
        back to training. Only a request already waiting is read, so an
        idle client does not hold training up; while the client has paused
        training (do_training=False), the poll waits for its next request
        instead."""
        gui = self.gui
        while gui.conn is not None:
            try:
                timeout = None if self._gui_paused else 0.0
                readable, _, _ = select.select([gui.conn], [], [], timeout)
                if not readable:
                    break
                do_training, keep_alive = gui.serve(
                    self._render_frame, self.source_path,
                    {"#": int(self.model.num_live()), "loss": self.ema_loss})
                self._gui_paused = not do_training
                if do_training and (it < end or not keep_alive):
                    break
            except (ConnectionError, OSError):
                gui.disconnect()
                self._gui_paused = False

    @torch.no_grad()
    def _render_frame(self, cam, width: int, height: int, scaling_modifier: float) -> dict:
        """A viewer frame of the model at the client's resolution."""
        settings = RasterSettings(width=width, height=height, sh_degree=self.active_sh_degree,
                                  scale_modifier=float(scaling_modifier), **self.raster_kwargs)
        p = self.model.params
        return render(cam.to(self.device), settings, p.xyz, torch.exp(p.scaling), p.rotation,
                      torch.sigmoid(p.opacity[:, 0]), splats_lib.features(p), self.bg,
                      live=self.model.live, device=self.device)

    # -- rendering for eval -------------------------------------------------

    @torch.no_grad()
    def render_view(self, cam: Camera, depth_ratio: Optional[float] = None):
        """The whole view of the model on this rank's device. Without splat
        sharding no collective (as the JAX Trainer's render_view ignores its
        mesh): one rank may call it alone. Under splat sharding it renders
        the whole model from every rank's segment, with the splats sharded
        as in training: a collective, every rank calls it."""
        kwargs = dict(self.raster_kwargs)
        if depth_ratio is not None:
            kwargs["depth_ratio"] = depth_ratio
        settings = RasterSettings(width=self.width, height=self.height,
                                  sh_degree=self.active_sh_degree, **kwargs)
        p = self.model.params
        return render(
            cam.arrays(self.device), settings,
            p.xyz, torch.exp(p.scaling), p.rotation,
            torch.sigmoid(p.opacity[:, 0]), splats_lib.features(p),
            self.bg, live=self.model.live, device=self.device,
            mesh=self.mesh if self.shard_splats else None, shard_splats=self.shard_splats,
        )
