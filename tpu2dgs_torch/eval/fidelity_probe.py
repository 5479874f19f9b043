"""Capacity-truncation fidelity on both workload regimes (port of
scripts/fidelity_probe.py).

    python3 -m tpu2dgs_torch.eval.fidelity_probe [W] [N_log2]

For the bench pileup and the opaque shell (eval/synthetic.py; defaults
800x800, 2^17 splats) one probe render at tile 2048, bin 16384, column
65536 and pack 131072 gives the demand maxima; a render at capacities
rounded up to 128 from them must overflow nowhere (the exact render, a
check). Then the scene is rendered at tile capacities 1024, 1792 and 2048
(bin 8192, column 65536): each one's PSNR against the exact render, the
largest alpha difference and the tile overflow. Every render is K1 three
times and K2 once. Prints a line a render and one JSON line
(`fidelity_probe`).
"""

from __future__ import annotations

import json
import sys

import torch

from tpu2dgs_torch import default_device
from tpu2dgs_torch.eval import synthetic
from tpu2dgs_torch.eval.timing import device_label
from tpu2dgs_torch.raster.api import RasterSettings, render
from tpu2dgs_torch.train import losses

TILE_CAPS = (1024, 1792, 2048)
EXACT_KEYS = ("tile_overflow_frac", "bin_overflow_frac", "col_overflow_frac")


def settings(w, h, tile_cap, bin_cap, col_cap, pack_cap) -> RasterSettings:
    return RasterSettings(
        width=w, height=h, sh_degree=3, backend="cuda",
        bin_capacity=bin_cap, tile_capacity=tile_cap,
        col_capacity=col_cap, grad_pack_capacity=pack_cap)


def r128(x: int) -> int:
    return -(-x // 128) * 128


@torch.no_grad()
def probe(cam, scene, w: int, h: int, dev) -> dict:
    """The demand maxima, the exact render's check and the truncation rows
    of one scene."""
    bg = torch.zeros(3, dtype=torch.float32, device=dev)
    # The zero-overflow reference for this scene: capacities sized off the
    # reported demand maxima of one probe render, then 0 overflow checked.
    pr = render(cam, settings(w, h, 2048, 16384, 65536, 131072), *scene, bg, device=dev)
    tile_max, bin_max, col_max = (int(float(pr[k])) for k in
                                  ("tile_count_max", "bin_count_max", "col_count_max"))
    s_exact = settings(w, h, r128(tile_max), r128(bin_max), r128(col_max), r128(16 * tile_max))
    exact = render(cam, s_exact, *scene, bg, device=dev)
    for k in EXACT_KEYS:
        if float(exact[k]) != 0.0:
            raise RuntimeError(f"the exact render overflows: {k} {float(exact[k])}")
    rows = []
    for cap in TILE_CAPS:
        o = render(cam, settings(w, h, cap, 8192, 65536, 0), *scene, bg, device=dev)
        rows.append({
            "tile_capacity": cap,
            "psnr": float(losses.psnr(torch.clamp(o["render"], 0, 1),
                                      torch.clamp(exact["render"], 0, 1))),
            "alpha_maxdiff": float(torch.max(torch.abs(o["rend_alpha"] - exact["rend_alpha"]))),
            "tile_overflow": float(o["tile_overflow_frac"])})
    return {"demand": {"tile": tile_max, "bin": bin_max, "col": col_max},
            "exact_overflow": {k: float(exact[k]) for k in EXACT_KEYS}, "truncated": rows}


def run(w: int = 800, n: int = 1 << 17, device=None) -> dict:
    dev = default_device(device)
    out = {}
    for name, make in (("bench-pileup", synthetic.make_bench_scene),
                       ("shell", synthetic.make_shell_scene)):
        cam, scene = make(w, w, n, device=dev)
        res = out[name] = probe(cam, scene, w, w, dev)
        d = res["demand"]
        print(f"{name}: true demand tile={d['tile']} bin={d['bin']} col={d['col']}")
        for row in res["truncated"]:
            print(f"  tile_cap {row['tile_capacity']}: trunc PSNR {row['psnr']:6.2f} dB, "
                  f"alpha maxdiff {row['alpha_maxdiff']:.4f}, "
                  f"tile overflow {row['tile_overflow']:.3f}", flush=True)
    return {"w": w, "h": w, "splats": n, "scenes": out, "device": device_label(dev)}


def main(argv=None, device=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    w = int(argv[0]) if len(argv) > 0 else 800
    n = 1 << (int(argv[1]) if len(argv) > 1 else 17)
    res = run(w, n, device)
    print(json.dumps({"fidelity_probe": res}), flush=True)
    return res


if __name__ == "__main__":
    main()
