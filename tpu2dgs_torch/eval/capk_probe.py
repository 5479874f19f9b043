"""Do the blend kernels' times follow the padded capacity or the walked
entries? (port of scripts/capk_probe.py)

    python3 -m tpu2dgs_torch.eval.capk_probe

The bench scene (800x800, 131,072 splats) is preprocessed, compacted,
packed and binned at bin 8192 and tile 2048 (K1 three times). Its tile
record lists are then cut or zero-padded to capacities 1024, 2048 and 4096
(counts min(raw counts, capacity), as the script takes them), and K2
(`blend_tiles`) and K3 (`blend_tiles_backward`, 32768 packed rows, an
all-ones cotangent) are timed on each: `cuda_ms` (host-visible, CUDA
events around 20 calls) and `device_ms` (the card's time, the calls queued
behind a spin). Tiles past 2048 entries walk zero records at 4096.

At unequal counts the walked entries differ too. So capacity 4096 also
runs with capacity 2048's counts: the same walked entries, and K2's output
and K3's written rows must be bit-equal to capacity 2048's (a check); only
that pair answers the question at equal work. Prints a line a capacity and
one JSON line (`capk_probe`). On the CPU the kernels' plain versions run
and nothing is timed.
"""

from __future__ import annotations

import json

import torch
import torch.nn.functional as F

from tpu2dgs_torch import default_device
from tpu2dgs_torch.eval import synthetic
from tpu2dgs_torch.eval.timing import cuda_ms, device_label, device_ms
from tpu2dgs_torch.raster import binning, preprocess
from tpu2dgs_torch.raster import cuda_backend as cb

W = H = 800
N_SPLATS = 1 << 17
BIN_CAP, TILE_CAP = 8192, 2048
# The last two are the equal-count pair: both at least GROUP, so K3's
# packed rows come in groups of the same size at both.
CAPKS = (1024, 2048, 4096)
PACK_CAP = 32768


@torch.no_grad()
def lists(dev, w: int = W, h: int = H, n: int = N_SPLATS, tile_cap: int = TILE_CAP):
    """The bench scene's tile record lists: (rec3 (T, NCH, capk), raw
    counts (T,), nty)."""
    cam, scene = synthetic.make_bench_scene(w, h, n, device=dev)
    splats = preprocess.preprocess(*scene, cam, w, h, 3)
    nbx, nty = -(-w // cb.BX), -(-h // cb.BY)
    comp = binning.compact_visible(splats, n)
    rec_c = cb.pack_records(splats)[comp.perm]
    n_vis = torch.clamp(comp.num_visible, max=n)
    rec3, raw_counts, _, _ = cb._bin_records(comp.x0, comp.x1, comp.y0, comp.y1, n_vis,
                                             rec_c, nbx, nty, BIN_CAP, tile_cap)
    return rec3, raw_counts, nty


def at_capk(rec3: torch.Tensor, capk: int) -> torch.Tensor:
    """The lists cut or zero-padded to `capk` entries, contiguous."""
    base = rec3.shape[2]
    r3 = rec3[:, :, :capk] if capk <= base else F.pad(rec3, (0, capk - base))
    return r3.contiguous()


def walked(counts: torch.Tensor) -> int:
    """Entries walked in whole staging chunks, as the script counts them."""
    return int(torch.sum(-(-counts.to(torch.int64) // cb.CHUNK) * cb.CHUNK))


@torch.no_grad()
def blend_both(r3, counts, nty, pack_cap: int = PACK_CAP):
    """K2's output and K3's written packed rows on these lists, with the
    arguments K3 was called with: (out, rows, (r3, counts, off, out,
    dout, nty, pack_cap))."""
    out = cb.blend_tiles(r3, counts, nty)
    dout = torch.ones_like(out)
    group = min(cb.GROUP, r3.shape[2])
    off = cb._packed_offsets(counts, out, group)
    args = (r3, counts, off, out, dout, nty, pack_cap)
    dpack = cb.blend_tiles_backward(*args)
    written = min(int(torch.sum(cb._effective_counts(counts, out, group))), pack_cap)
    return out, dpack[:written], args


def _times(r3, counts, nty, k3_args, timed: bool) -> dict:
    if not timed:
        return {k: None for k in ("k2_cuda_ms", "k2_device_ms", "k3_cuda_ms", "k3_device_ms")}

    def k2():
        return cb.blend_tiles(r3, counts, nty)

    def k3():
        return cb.blend_tiles_backward(*k3_args)

    return {"k2_cuda_ms": cuda_ms(k2), "k2_device_ms": device_ms(k2),
            "k3_cuda_ms": cuda_ms(k3), "k3_device_ms": device_ms(k3)}


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@torch.no_grad()
def run(device=None, w: int = W, h: int = H, n: int = N_SPLATS, tile_cap: int = TILE_CAP,
        capks=CAPKS, pack_cap: int = PACK_CAP) -> dict:
    """Time K2 and K3 at each capacity and check the equal-count pair;
    returns the numbers main prints. The keywords cut the scene below the
    script's for tests."""
    dev = default_device(device)
    timed = dev.type == "cuda"
    rec3, raw_counts, nty = lists(dev, w, h, n, tile_cap)
    rows, outs = [], {}
    for capk in capks:
        r3 = at_capk(rec3, capk)
        counts = torch.clamp(raw_counts, max=capk).to(torch.int32)
        out, dpack, args = blend_both(r3, counts, nty, pack_cap)
        if not (bool(torch.isfinite(out).all()) and bool(torch.isfinite(dpack).all())):
            raise RuntimeError(f"capk {capk}: K2 or K3 gave a non-finite value")
        outs[capk] = (out, dpack, counts)
        rows.append({"capk": capk, "walked_entries": walked(counts),
                     "k3_rows_written": dpack.shape[0], **_times(r3, counts, nty, args, timed)})
        print(f"capk={capk} walked_entries={rows[-1]['walked_entries']} "
              f"K2 {rows[-1]['k2_cuda_ms']} ms  K3 {rows[-1]['k3_cuda_ms']} ms", flush=True)

    lo, hi = capks[-2:]
    out_lo, dpack_lo, counts_lo = outs[lo]
    r3 = at_capk(rec3, hi)
    out, dpack, args = blend_both(r3, counts_lo, nty, pack_cap)
    if not (bits_equal(out, out_lo) and bits_equal(dpack, dpack_lo)):
        raise RuntimeError(f"capk {hi} with capk {lo}'s counts: K2's output or K3's rows "
                           f"differ from capk {lo}'s")
    pair = {"capk": hi, "counts_of": lo, "walked_entries": walked(counts_lo), "bit_equal": True,
            **_times(r3, counts_lo, nty, args, timed)}
    print(f"capk={hi} at capk {lo}'s counts: walked_entries={pair['walked_entries']} "
          f"K2 {pair['k2_cuda_ms']} ms  K3 {pair['k3_cuda_ms']} ms", flush=True)
    return {"w": w, "h": h, "splats": n, "base_capk": rec3.shape[2], "tiles": rec3.shape[0],
            "pack_cap": pack_cap, "capks": rows, "equal_counts": pair,
            "device": device_label(dev)}


def main(argv=None, device=None) -> dict:
    del argv  # no flags
    res = run(device)
    print(json.dumps({"capk_probe": res}), flush=True)
    return res


if __name__ == "__main__":
    main()
