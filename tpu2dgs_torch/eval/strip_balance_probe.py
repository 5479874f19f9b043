"""Tile-row strip load imbalance under multi-device sharding (port of
scripts/strip_balance_probe.py).

    python3 -m tpu2dgs_torch.eval.strip_balance_probe [W] [N_log2]

A step under tile-row sharding (parallel/sharded.py) runs at its slowest
strip's pace, so max/mean strip work bounds the scaling. This probe counts
every tile's blended entries once (binning at bin 16384, column 65536 and
tile 1792: K1 three times a scene, each count clamped at the tile
capacity) and sums them per device under three assignments of tile rows:

  * static: device d owns the coarse rows [d rows_per, (d+1) rows_per),
    sharded.py's strip rows;
  * cyclic: coarse row r (4 tile rows) goes to device r % D;
  * balanced: the work-quantile windows the port deploys
    (`parallel.sharded._balance_boundaries`, with its error from the box
    proxy), each summing the true per-row counts.

for the bench pileup and the opaque shell (eval/synthetic.py; defaults
800x800, 2^17 splats) at 2, 4 and 8 devices. Counts do not depend on the
platform. Prints the script's lines and one JSON line
(`strip_balance_probe`).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from tpu2dgs_torch import default_device
from tpu2dgs_torch.eval import synthetic
from tpu2dgs_torch.eval.timing import device_label
from tpu2dgs_torch.parallel.sharded import _balance_boundaries
from tpu2dgs_torch.raster import binning, preprocess
from tpu2dgs_torch.raster import cuda_backend as cb

TILE_CAP = 1792
DEVICES = (2, 4, 8)


@torch.no_grad()
def tile_counts(cam, scene, w, h, tile_cap):
    """Exact per-tile clamped entry counts, (nbx, nty) column-major, nty
    and the preprocessed splats."""
    splats = preprocess.preprocess(*scene, cam, w, h, 3)
    n = scene[0].shape[0]
    comp = binning.compact_visible(splats, n)
    rec = cb.pack_records(splats)
    nbx, nty = -(-w // cb.BX), -(-h // cb.BY)
    _, raw_counts, _, _ = cb._bin_records(
        comp.x0, comp.x1, comp.y0, comp.y1, torch.clamp(comp.num_visible, max=n), rec,
        nbx, nty, bin_cap=16384, cap=tile_cap, col_cap=65536, ids=comp.perm)
    counts = torch.clamp(raw_counts, max=tile_cap).cpu().numpy().reshape(nbx, nty)
    return counts, nty, splats


def imbalance(row_work, nty, n_dev, cyclic):
    """max/mean strip work for D devices (coarse rows = 4 tile rows), and
    each device's work."""
    n_coarse = -(-nty // 4)
    cw = np.array([row_work[4 * r: 4 * (r + 1)].sum() for r in range(n_coarse)], np.float64)
    dev = np.zeros(n_dev)
    if cyclic:
        for r in range(n_coarse):
            dev[r % n_dev] += cw[r]
    else:
        rows_per = -(-(-(-nty // n_dev)) // 4) * 4  # sharded.py's strip rows
        for r in range(n_coarse):
            dev[min(4 * r // rows_per, n_dev - 1)] += cw[r]
    mean = dev.sum() / n_dev
    return dev.max() / max(mean, 1e-9), dev


def balanced_imbalance(splats, row_work, w, nty, n_dev):
    """max/mean strip work under the deployed work-quantile windows
    (`_balance_boundaries`), summing the true per-row entry counts in each
    window, and each device's work."""
    c, e = splats.box_center, splats.box_half
    b = _balance_boundaries(c[:, 0] - e[:, 0], c[:, 0] + e[:, 0], c[:, 1] - e[:, 1],
                            c[:, 1] + e[:, 1], splats.visible, w, nty, n_dev,
                            tile_cap=TILE_CAP).cpu().numpy()
    dev = np.array([row_work[b[d]:b[d + 1]].sum() for d in range(n_dev)])
    return dev.max() / max(dev.sum() / n_dev, 1e-9), dev


def run(w: int = 800, n: int = 1 << 17, device=None) -> dict:
    where = default_device(device)
    out = {}
    for name, make in (("bench-pileup", synthetic.make_bench_scene),
                       ("shell", synthetic.make_shell_scene)):
        cam, scene = make(w, w, n, device=where)
        counts, nty, splats = tile_counts(cam, scene, w, w, TILE_CAP)
        row_work = counts.sum(axis=0)  # (nty,)
        total = int(counts.sum())
        print(f"\n{name}: {w}x{w}, {n} splats, total entries {total}")
        rows = {}
        for n_dev in DEVICES:
            r_c, dev_c = imbalance(row_work, nty, n_dev, cyclic=False)
            r_i, _ = imbalance(row_work, nty, n_dev, cyclic=True)
            r_b, dev_b = balanced_imbalance(splats, row_work, w, nty, n_dev)
            print(f"  D={n_dev}: static max/mean={r_c:.3f} (eff bound {1 / r_c:.2f})  "
                  f"cyclic={r_i:.3f} ({1 / r_i:.2f})  BALANCED={r_b:.3f} ({1 / r_b:.2f})")
            if n_dev == DEVICES[-1]:
                print(f"       static   per-dev: {np.array2string(dev_c / 1e3, precision=1)}k")
                print(f"       balanced per-dev: {np.array2string(dev_b / 1e3, precision=1)}k")
            rows[n_dev] = {"static": float(r_c), "cyclic": float(r_i), "balanced": float(r_b),
                           "static_per_device": dev_c.tolist(),
                           "balanced_per_device": dev_b.tolist()}
        out[name] = {"total_entries": total, "devices": rows}
    return {"w": w, "h": w, "splats": n, "tile_capacity": TILE_CAP, "scenes": out,
            "device": device_label(where)}


def main(argv=None, device=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    w = int(argv[0]) if len(argv) > 0 else 800
    n = 1 << (int(argv[1]) if len(argv) > 1 else 17)
    res = run(w, n, device)
    print(json.dumps({"strip_balance_probe": res}), flush=True)
    return res


if __name__ == "__main__":
    main()
