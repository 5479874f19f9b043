"""Device timing shared by the probes and the smoke run."""

from __future__ import annotations

import subprocess
import time
from unittest import mock

import torch


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
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


def device_ms(fn, reps: int = 200, warmup: int = 2) -> float:
    """Mean device time of fn() with the card running the calls back to
    back: they are queued behind a spin kernel that outlasts the host's
    time to queue them, so a call shorter than its host overhead is timed
    by the card and not by the host. The spin grows fourfold, up to three
    times, while it ends before the last call is queued."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 1 << 26  # about 35 ms at the H100's clocks
    for _ in range(4):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        spun_out = start.query()  # the card reached the calls before all were queued
        end.synchronize()
        if not spun_out:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError(f"the host queued {reps} calls slower than a spin of {cycles // 4} cycles")


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them: they
    belong beside every time measured on it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def device_label(dev: torch.device) -> str:
    """What a result was measured on: the card's name and power limit
    (`card`) on a GPU, "cpu" on the CPU."""
    return card() if dev.type == "cuda" else "cpu"


def synchronize(dev: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Stopwatch:
    """Host seconds spent inside chosen functions, each call bracketed by
    `sync` (a device synchronize on the GPU): where a run's time goes."""

    def __init__(self, sync=torch.cuda.synchronize):
        self.sync = sync
        self.seconds: dict[str, list[float]] = {}

    def watch(self, owner, name: str, label: str):
        """A patch of owner.name that adds each call's seconds to `label`."""
        orig = getattr(owner, name)

        def timed(*args, **kwargs):
            self.sync()
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                self.sync()
                self.seconds.setdefault(label, []).append(time.perf_counter() - t0)

        return mock.patch.object(owner, name, timed)

    def totals(self) -> dict[str, float]:
        return {k: sum(v) for k, v in self.seconds.items()}
