"""The bytes every collective of a sharded training render moves (port of
scripts/collective_probe.py).

    python3 -m tpu2dgs_torch.eval.collective_probe [N_log2] [W] [--ranks D]

The script's workload: the bench scene (`synthetic.make_bench_scene(W, W,
2^N_log2)`, defaults 2^14 splats at 256x256), SH 3, bin capacity 2048 and
tile capacity 1024, and its loss, sum(render^2) + sum(rend_dist), forward
and backward, on D ranks (default 8, the script's mesh), in its four
settings: the splats sharded with the survivors all-gathered (xfer 0) and
routed to the strips (xfer max(256, k_loc // 4)), and tile rows in static
strips and in work windows. For each it prints the script's report, the
total MB a frame and each kind's MB a frame, per rank, and at the end one
JSON line (`collective_probe`) with the same figures in bytes, the bytes
by part of the program (`parallel.distributed.BYTES`), each rank's kernel
launches and, for the routed setting, the exchange's overflow share and
largest message demand (whether xfer held every strip's demand).

The JAX script sums the output bytes of each collective in the compiled
program; the port has no such program, so the collective wrappers count
the same (`parallel.distributed.BYTES`, per rank). The ranks go to the
host's GPUs, several to a GPU over gloo where there are fewer GPUs than
ranks, or with device="cpu" to CPU ranks: the bytes depend on the shapes,
not on the link, which is why the JAX script runs on virtual devices.
"""

from __future__ import annotations

import argparse
import json

import torch

from tpu2dgs_torch import default_device
from tpu2dgs_torch.parallel import distributed, rehearsal
from tpu2dgs_torch.raster.api import RasterSettings

CAPS = dict(bin_capacity=2048, tile_capacity=1024)


def settings(n: int, w: int, ranks: int) -> list[tuple[str, RasterSettings, bool]]:
    """The script's four settings: (label, RasterSettings, splats sharded)."""
    base = dict(width=w, height=w, sh_degree=3, **CAPS)
    xfer = max(256, n // ranks // 4)
    return [("splats all-gather (xfer=0)", RasterSettings(**base, xfer_capacity=0), True),
            (f"splats routed (xfer={xfer})", RasterSettings(**base, xfer_capacity=xfer), True),
            *((f"rows row_balance={mode}", RasterSettings(**base, row_balance=mode), False)
              for mode in ("static", "work"))]


def rank_devices(ranks: int, dev: torch.device):
    """The ranks' devices: CPU ranks, or the host's GPUs in turn (several
    ranks a GPU where it has fewer GPUs than ranks), and how they talk."""
    if dev.type == "cpu":
        return "cpu", "gloo on the CPU"
    n_gpu = torch.cuda.device_count()
    devices = [torch.device("cuda", r % n_gpu) for r in range(ranks)]
    _, backend = distributed.rank_devices(ranks, devices)
    return devices, f"{backend} on {min(ranks, n_gpu)} GPU(s)"


def run(n_log2: int = 14, w: int = 256, ranks: int = 8, device=None) -> dict:
    dev = default_device(device)
    n = 1 << n_log2
    if n % ranks:
        raise ValueError(f"{n} splats do not split over {ranks} ranks")
    cases = settings(n, w, ranks)
    devices, transport = rank_devices(ranks, dev)
    every = distributed.spawn(rehearsal.probe_rank, ranks,
                              args=(w, n, [s for _, s, _ in cases], [x for _, _, x in cases]),
                              device=devices)
    out = []
    for i, (label, _, split) in enumerate(cases):
        got = [rank[i] for rank in every]
        per_kind = got[0]["bytes"]  # rank 0's; `ranks_equal` says whether every rank's is
        total = sum(per_kind.values())
        print(f"{label}: {total / 1e6:.2f} MB/frame total")
        for k, v in sorted(per_kind.items()):
            print(f"    {k.replace('_', '-'):20s} {v / 1e6:8.2f} MB")
        out.append({"label": label, "shard_splats": split, "bytes_total": total,
                    "bytes": per_kind, "parts": got[0]["parts"],
                    "ranks_equal": all(g["bytes"] == per_kind for g in got),
                    "launches": [g["launches"] for g in got], "xfer": got[0]["xfer"]})
    return {"splats": n, "w": w, "h": w, "ranks": ranks, "transport": transport,
            "per": "rank, one forward and backward", "capacities": CAPS, "settings": out,
            "note": "bytes depend on the shapes, not the link"}


def main(argv=None, device=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_log2", nargs="?", type=int, default=14)
    parser.add_argument("w", nargs="?", type=int, default=256)
    parser.add_argument("--ranks", type=int, default=8)
    args = parser.parse_args(argv)
    res = run(args.n_log2, args.w, args.ranks, device)
    print(json.dumps({"collective_probe": res}), flush=True)
    return res


if __name__ == "__main__":
    main()
