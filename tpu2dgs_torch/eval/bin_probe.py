"""Per-level timing of the record-carrying binning pipeline (port of
scripts/bin_probe.py).

    python3 -m tpu2dgs_torch.eval.bin_probe

The bench scene (800x800, 131,072 splats) is preprocessed, depth-compacted
and packed into records; then each binning level runs alone on the inputs
the level before it produced, timed by CUDA events after a warm-up:

  L1 columns               select_values, AABB test
  col gather+transpose     the one row gather that builds the column lists
  L2 coarse bins (exact)   select_values, exact coverage
  L3 fine tiles (exact)    select_values, exact coverage
  L2 count-only            select_counts on L2's inputs
  L3 count-only            select_counts on L3's inputs

The count-only levels run the same hit tests and carry nothing: what a
count pass would cost a design that first sizes packed per-tile lists and
then fills them. Their counts must equal the counts L2 and L3 returned.
The command line also times each select and count level's kernel alone
(`run(alone=True)`): its arguments prepared once, the launcher called back
to back on the card (`alone_ms()`, which chip_smoke.py's kernel phase uses
too); those launches are not a pass and are not counted in `launches`.
Runs on the GPU and raises without one.
"""

from __future__ import annotations

import json

import torch

from tpu2dgs_torch import default_device
from tpu2dgs_torch.eval import synthetic
from tpu2dgs_torch.eval.timing import card, cuda_ms, device_ms
from tpu2dgs_torch.native import build as native
from tpu2dgs_torch.raster import binning, cuda_backend as cb, preprocess, select_kernel

W = H = 800
N_SPLATS = 1 << 17
BIN_CAP, TILE_CAP, COL_CAP = 8192, 2048, 32768  # the bench capacities


def alone_ms(launch, kwargs, cap=None) -> float:
    """Device time of a select kernel alone: its arguments prepared once
    (`select_kernel._prepare`), `launch` (`select_kernel._launch` with the
    level's `cap`, or `select_kernel._count_launch` with cap None) called
    200 times, run back to back by the card (`device_ms`). A wrapper's own
    time is the caller's: for kernels this short that is the host's time,
    not the card's."""
    box_idx = kwargs.get("box_idx", (0, 1, 2, 3))
    rects, stacked, parent, pcnt, pads = select_kernel._prepare(
        kwargs["row_rects"], kwargs["cand_channels"], kwargs["parent_of_row"],
        cap or select_kernel.LB, kwargs["parent_counts"], kwargs.get("pad_vals"), box_idx)
    exact_idx = kwargs.get("exact_idx")
    if cap is None:
        return device_ms(lambda: launch(rects, stacked, parent, pcnt, box_idx, exact_idx))
    return device_ms(lambda: launch(rects, stacked, parent, pcnt, cap, pads, box_idx,
                                    exact_idx))


@torch.no_grad()
def run(device=None, w: int = W, h: int = H, n: int = N_SPLATS, bin_cap: int = BIN_CAP,
        tile_cap: int = TILE_CAP, col_cap: int = COL_CAP, reps: int = 20,
        alone: bool = False) -> dict:
    """Run and time every level once; prints one line per level and
    returns the times (ms), the launches made and the list totals, and with
    `alone` each level's kernel time alone (`alone_ms`)."""
    dev = default_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the binning probe times CUDA kernels: it needs a GPU")
    cam, scene = synthetic.make_bench_scene(w, h, n, device=dev)
    splats = preprocess.preprocess(*scene, cam, w, h, 3)
    nbx, nty = -(-w // cb.BX), -(-h // cb.BY)
    comp = binning.compact_visible(splats, n)
    rec = cb.pack_records(splats)
    n_vis = torch.clamp(comp.num_visible, max=n)
    col_capk, bin_capk, capk = cb._level_caps(n, bin_cap, tile_cap, col_cap)

    times = {}

    def timed(label, fn):
        out = fn()
        times[label] = cuda_ms(fn, reps=reps)
        print(f"{label:<24s} {times[label]:8.3f} ms", flush=True)
        return out

    before = native.LAUNCHES.copy()
    l1 = cb._l1_args(comp.x0, comp.x1, comp.y0, comp.y1, n_vis, nbx, nty, comp.perm)
    cchan, col_cnt = timed("L1 columns",
                           lambda: select_kernel.select_values(cap=col_capk, **l1))
    l2_in = timed("col gather+transpose", lambda: cb._column_lists(rec, cchan, col_cnt))
    l2 = cb._l2_args(l2_in, col_cnt, nbx, nty)
    bchan, bin_counts = timed("L2 coarse bins (exact)",
                              lambda: select_kernel.select_values(cap=bin_capk, **l2))
    l3 = cb._l3_args(bchan, bin_counts, nbx, nty)
    _, tile_counts = timed("L3 fine tiles (exact)",
                           lambda: select_kernel.select_values(cap=capk, **l3))
    bin_only = timed("L2 count-only", lambda: select_kernel.select_counts(**l2))
    tile_only = timed("L3 count-only", lambda: select_kernel.select_counts(**l3))
    torch.cuda.synchronize()
    # Each level ran once for its result, twice to warm up and `reps` times.
    passes = 1 + 2 + reps
    launches = dict(native.LAUNCHES - before)
    if launches != {"select_values": 3 * passes, "select_counts": 2 * passes}:
        raise RuntimeError(f"{passes} passes launched {launches}: want 3 select_values "
                           "and 2 select_counts launches per pass")

    if not (torch.equal(bin_only, bin_counts) and torch.equal(tile_only, tile_counts)):
        raise RuntimeError("count-only levels disagree with the counts of L2 / L3")
    kernels_alone = {}
    if alone:
        kernels_alone = {"L1": alone_ms(select_kernel._launch, l1, col_capk),
                         "L2": alone_ms(select_kernel._launch, l2, bin_capk),
                         "L3": alone_ms(select_kernel._launch, l3, capk),
                         "L2 count-only": alone_ms(select_kernel._count_launch, l2),
                         "L3 count-only": alone_ms(select_kernel._count_launch, l3)}
        print("kernels alone, ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in kernels_alone.items()), flush=True)
    col_total = int(torch.clamp(col_cnt, max=col_capk).sum())
    bin_total = int(torch.clamp(bin_counts, max=bin_capk).sum())
    print(f"col counts: {col_total} bin counts: {bin_total}", flush=True)
    return {"ms": times, "alone_ms": kernels_alone, "launches": launches, "passes": passes,
            "col_counts": col_total,
            "bin_counts": bin_total, "tile_counts": int(tile_counts.sum()),
            "rows": {"L1": nbx, "L2": int(bin_counts.shape[0]), "L3": int(tile_counts.shape[0])},
            "caps": {"col": col_capk, "bin": bin_capk, "tile": capk}}


def main(argv=None, device=None) -> None:
    del argv  # no flags
    result = run(device, alone=True)
    print(json.dumps({"bin_probe": result, "card": card()}), flush=True)


if __name__ == "__main__":
    main()
