"""Multi-process runtime for tile-row rendering on torch.distributed (port
of tpu2dgs/parallel/distributed.py).

PyTorch's idiom is one process per device: a rank renders its strip of
tile rows on its own device and meets the other ranks in collectives. The
JAX package's `Mesh` (devices along a "rows" axis) becomes `Mesh` below,
one rank's view of such a group: the process group, the rank, the number
of ranks and the rank's device.

  * `initialize(device)` joins the group a launcher set up (torchrun and
    the like: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK) on
    the device the caller resolved; one process is a no-op.
  * `make_global_mesh(device)` and `make_mesh(n, device)` are the ranks of
    that group.
  * `spawn(fn, n, ...)` starts n ranks on this host (on its GPUs unless
    the caller asks for the CPU), joins them into a group over
    tcp://localhost, calls fn(mesh, *args) on each and returns their
    results: what `cli.train --n_devices N`, the tests and the smoke run
    use. `configure_cpu_rehearsal` joins a rank of a CPU rehearsal (gloo,
    one PyTorch thread), the no-hardware dress rehearsal of a multi-GPU
    run.

NCCL carries the collectives when every rank has a GPU of its own; gloo
does otherwise (the CPU, or several ranks sharing one GPU, which NCCL
refuses). Gloo is given host tensors: a rank on a GPU under gloo stages
each collective's tensors through host memory (`all_gather`,
`all_reduce`, `all_to_all`, `reduce_scatter`, `broadcast`,
`gather_to_host`). `host_mesh` gives the same ranks over gloo in host
memory, for small control tensors the host reads. Every group is made
with a timeout, so ranks that diverge fail in a collective instead of
waiting on each other for ever.

`BYTES` counts, per kind of collective, the bytes each wrapper's output
holds on this rank: the convention of the JAX package's collective probe
(`scripts/collective_probe.py`, the output bytes of each collective in
the compiled program), so `eval.collective_probe` can take the bytes of
one step.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing
import os
import queue
import socket
import time
import traceback
from collections import Counter
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from tpu2dgs_torch import default_device

# Seconds a collective waits for the other ranks before it fails.
COLLECTIVE_TIMEOUT_S = 300.0

# Output bytes on this rank by (part, kind): the kinds are "all_gather",
# "all_reduce", "all_to_all", "reduce_scatter", "broadcast", and
# "gather_to_host", which has no counterpart among the JAX program's
# collectives; the part is the caller's `part=` ("exchange": a splat
# exchange and its cotangents; "assembly": an image's rows and counters;
# "gradients": the splat-gradient sum; "other"). Counted by each wrapper;
# a caller that wants the bytes of one step clears it first
# (`reset_bytes`) and reads them after (`snapshot_bytes`).
BYTES: Counter = Counter()


def reset_bytes() -> None:
    BYTES.clear()


def snapshot_bytes(by_part: bool = False) -> dict:
    """The bytes counted since the last `reset_bytes`: {kind: bytes}, or
    with `by_part` {part: {kind: bytes}}."""
    out: dict = {}
    for (part, kind), n in sorted(BYTES.items()):
        if by_part:
            out.setdefault(part, {})[kind] = n
        else:
            out[kind] = out.get(kind, 0) + n
    return out


def _count(part: str, kind: str, *outs: torch.Tensor) -> None:
    BYTES[part, kind] += sum(t.numel() * t.element_size() for t in outs)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D group of ranks that share tile rows.

    `group` is the torch.distributed process group (None: the default
    group), `rank` this process's place in it, `size` the number of ranks
    and `device` the device this rank renders on."""

    group: Any
    rank: int
    size: int
    device: torch.device

    @property
    def staged(self) -> bool:
        """Whether collectives go through host memory: gloo with a GPU."""
        return self.device.type == "cuda" and dist.get_backend(self.group) == "gloo"


def _to_wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    # gloo takes host tensors: a rank on a GPU stages through host memory
    return t.detach().cpu() if mesh.staged else t.detach()


def all_gather(mesh: Mesh, t: torch.Tensor, part: str = "other") -> torch.Tensor:
    """(size, *t.shape): every rank's `t`, in rank order, on t's device.
    Every rank's tensor has the same shape."""
    src = _to_wire(mesh, t).contiguous()
    out = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(out, src, group=mesh.group)
    _count(part, "all_gather", *out)
    return torch.stack(out).to(t.device)


def all_reduce(mesh: Mesh, t: torch.Tensor, op=dist.ReduceOp.SUM,
               part: str = "other") -> torch.Tensor:
    """`op` of every rank's `t` (same shape on each), on t's device."""
    buf = _to_wire(mesh, t).clone()
    dist.all_reduce(buf, op=op, group=mesh.group)
    _count(part, "all_reduce", buf)
    return buf.to(t.device)


def all_to_all(mesh: Mesh, t: torch.Tensor, part: str = "other") -> torch.Tensor:
    """(size, ...) on each rank -> (size, ...): block s of the result is
    block `rank` of rank s's `t` (every rank's `t` has the same shape)."""
    src = _to_wire(mesh, t).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group)
    _count(part, "all_to_all", out)
    return out.to(t.device)


def reduce_scatter(mesh: Mesh, t: torch.Tensor, part: str = "other") -> torch.Tensor:
    """(size * k, ...) on each rank -> (k, ...): block `rank` of the sum of
    every rank's `t` (the same shape on each)."""
    src = _to_wire(mesh, t).contiguous()
    out = src.new_empty((src.shape[0] // mesh.size, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=mesh.group)
    _count(part, "reduce_scatter", out)
    return out.to(t.device)


def _peer(mesh: Mesh, r: int) -> int:
    """The global rank of the mesh's rank r."""
    return r if mesh.group is None else dist.get_global_rank(mesh.group, r)


def broadcast(mesh: Mesh, t: torch.Tensor, src: int = 0, part: str = "other") -> torch.Tensor:
    """Rank `src`'s `t` on every rank (each passes a tensor of the same
    shape and type; the others' values are not read), on t's device. For
    small tensors: a control word, a count."""
    buf = _to_wire(mesh, t).clone()
    dist.broadcast(buf, src=_peer(mesh, src), group=mesh.group)
    _count(part, "broadcast", buf)
    return buf.to(t.device)


def host_mesh(mesh: Mesh) -> Mesh:
    """The ranks of `mesh` over gloo with tensors in host memory, for
    control tensors the host reads: reading a collective's result off a GPU
    would make the host wait for the device. The mesh's own group when it
    is gloo; else a new gloo group of the same ranks, which every rank
    makes together (a collective)."""
    group = mesh.group
    if dist.get_backend(group) != "gloo":
        group = dist.new_group([_peer(mesh, r) for r in range(mesh.size)], backend="gloo",
                               timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return Mesh(group, mesh.rank, mesh.size, torch.device("cpu"))


def gather_to_host(mesh: Mesh, t: torch.Tensor, dst: int = 0) -> Optional[list]:
    """Every rank's `t` (the same shape on each), in rank order, in host
    memory on rank `dst`; None on the others. Point to point, one rank's
    tensor at a time: `dst` never holds more than one other rank's `t` on
    its device."""
    wire = _to_wire(mesh, t).contiguous()
    if mesh.rank != dst:
        dist.send(wire, dst=_peer(mesh, dst), group=mesh.group)
        return None
    out = []
    for r in range(mesh.size):
        if r == dst:
            out.append(wire.cpu())
            continue
        buf = torch.empty_like(wire)
        dist.recv(buf, src=_peer(mesh, r), group=mesh.group)
        out.append(buf.cpu())
    _count("other", "gather_to_host", *out)  # the output is dst's alone
    return out


def _device_of_rank(device) -> torch.device:
    """The device a launched rank runs on: the CPU when the caller asked
    for it, the GPU it named (a rank of a group `spawn` made), else its
    GPU, cuda:LOCAL_RANK."""
    dev = torch.device(device)
    if dev.type == "cpu" or dev.index is not None:
        return dev
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0))))


def initialize(device) -> None:
    """Join the process group a launcher described in the environment:
    WORLD_SIZE and RANK, MASTER_ADDR and MASTER_PORT (read by
    torch.distributed's env:// method), LOCAL_RANK for the GPU, with
    `device` the caller resolved. Idempotent; a single process (no
    WORLD_SIZE, or 1) is a no-op. On the CPU gloo, else NCCL with rank r on
    cuda:LOCAL_RANK."""
    if dist.is_initialized():
        return
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return
    rank = int(os.environ["RANK"])
    dev = _device_of_rank(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo" if dev.type == "cpu" else "nccl", init_method="env://",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def make_global_mesh(device) -> Mesh:
    """Every rank of the default group, on `device` as `initialize` placed
    it: the CPU, or the rank's GPU."""
    return Mesh(None, dist.get_rank(), dist.get_world_size(), _device_of_rank(device))


def make_mesh(n_devices: int, device) -> Mesh:
    """A mesh of n devices: with one process per device, the n ranks of
    the group (start n ranks, by `spawn` or a launcher, to have n)."""
    world = dist.get_world_size()
    if n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs {n_devices} ranks; the group "
                         f"has {world}")
    return make_global_mesh(device)


def is_primary() -> bool:
    """Rank 0, or a single process: the one that logs and writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _join(rank: int, world: int, port: int, backend: str, device: torch.device) -> Mesh:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return Mesh(None, rank, world, device)


def configure_cpu_rehearsal(rank: int, world_size: int, port: int) -> Mesh:
    """Join rank `rank` of a CPU rehearsal of `world_size` ranks: gloo over
    tcp://localhost:port, one PyTorch thread a rank (ranks share the host's
    cores). The sharding program is the multi-GPU one; only the transport
    differs."""
    torch.set_num_threads(1)
    return _join(rank, world_size, port, "gloo", torch.device("cpu"))


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_devices(n: int, device) -> tuple[list[torch.device], str]:
    """The device of each of n ranks and the backend they use: "cpu" gives
    n CPU ranks on gloo; "cuda" ranks on cuda:0 .. cuda:n-1 on NCCL (raises
    when the host has fewer GPUs); a list names each rank's device, on NCCL
    when they are distinct GPUs, else on gloo."""
    if isinstance(device, (str, torch.device)):
        kind = torch.device(device).type
        if kind == "cpu":
            return [torch.device("cpu")] * n, "gloo"
        if kind != "cuda":
            raise ValueError(f"ranks run on cpu or cuda, not {device}")
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(f"{n} ranks need {n} GPUs; this host has {have}")
        return [torch.device("cuda", r) for r in range(n)], "nccl"
    devs = [torch.device(d) for d in device]
    if len(devs) != n:
        raise ValueError(f"{len(devs)} devices named for {n} ranks")
    distinct_gpus = all(d.type == "cuda" and d.index is not None for d in devs) and \
        len({d.index for d in devs}) == n
    return devs, ("nccl" if distinct_gpus else "gloo")


def _rank_main(fn, rank, devices, backend, port, args, results) -> None:
    """A spawned rank: join the group, run fn(mesh, *args), send back
    (rank, ok, result or traceback), leave the group."""
    try:
        if devices[rank].type == "cpu":
            mesh = configure_cpu_rehearsal(rank, len(devices), port)
        else:
            mesh = _join(rank, len(devices), port, backend, devices[rank])
        try:
            results.put((rank, True, fn(mesh, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, n: int, args: Sequence = (), device=None,
          timeout_s: Optional[float] = 900.0):
    """Run fn(mesh, *args) on n new ranks of one group and return their
    results, in rank order. `timeout_s` None waits as long as the ranks
    run (a training run); a rank stuck in a collective still fails after
    COLLECTIVE_TIMEOUT_S.

    `fn` and `args` are pickled to each rank (fn by its import path), and so
    is each result: return host data. `device` is as `rank_devices` takes
    it; None, the default, is the GPUs (cuda:0 .. cuda:n-1, which raises
    without n of them): pass "cpu" for CPU ranks. Raises RuntimeError with
    the first failing rank's traceback, and TimeoutError when the ranks
    have not all answered within `timeout_s`; either way every rank is
    stopped before it returns."""
    devices, backend = rank_devices(n, default_device(device) if device is None else device)
    port = free_port()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, devices, backend, port, tuple(args), results))
             for r in range(n)]
    for p in procs:
        p.start()
    got: dict[int, Any] = {}
    deadline = time.monotonic() + (math.inf if timeout_s is None else timeout_s)
    try:
        # Drain the queue before joining: a rank blocks on exit until its
        # result has been read.
        while len(got) < n:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                # A rank that exited cleanly has sent its result; one that
                # died (a signal, a crash in native code) never will.
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)}
                if dead:
                    raise RuntimeError(f"ranks of {n} died without a result (rank: exit "
                                       f"code): {dead}") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(n)) - set(got))} of {n} "
                                       f"did not answer in {timeout_s} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
            got[rank] = value
        for p in procs:
            p.join(timeout=min(max(deadline - time.monotonic(), 1.0), 60.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        results.close()
    return [got[r] for r in range(n)]
