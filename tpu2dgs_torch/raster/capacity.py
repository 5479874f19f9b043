"""Capacity growth from the backends' overflow counters: one rule for the
Trainer's adaptive caps (train/loop.py) and for renders of a stored model
that heal theirs (cli/render.py, cli/view.py).

A backend reports, per render, the fraction of its lists that overflowed a
capacity (`*_overflow_frac`) and the largest demand it saw (`*_count_max`).
`grow_caps` turns a nonzero fraction into a larger cap; `CapacityHealer`
renders a view again until no counter fires, or until one fires with its
cap at the ceiling, and says so. The probes (eval/*_probe.py) call
`api.render` directly: they measure truncation at the capacities they are
given.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

# The RasterSettings knob each overflow fraction is healed by, and the true
# demand maximum reported beside it: growth sizes the new cap directly from
# the demand instead of climbing a 1.5x ladder. The xfer keys belong to the
# multi-device splat exchange and appear only when a backend reports them.
OVERFLOW_CAP_OF = {
    "tile_overflow_frac": "tile_capacity",
    "bin_overflow_frac": "bin_capacity",
    "col_overflow_frac": "col_capacity",
    "grad_pack_overflow_frac": "grad_pack_capacity",
    "xfer_overflow_frac": "xfer_capacity",
}
OVERFLOW_DEMAND_OF = {
    "tile_overflow_frac": "tile_count_max",
    "bin_overflow_frac": "bin_count_max",
    "col_overflow_frac": "col_count_max",
    "grad_pack_overflow_frac": "grad_pack_max",
    "xfer_overflow_frac": "xfer_count_max",
}
# The growth ceilings: the JAX package's, kept so both packages heal alike.
MAX_CAPS = {
    "tile_capacity": 16_384, "bin_capacity": 20_480, "col_capacity": 61_440,
    "grad_pack_capacity": 1 << 22, "xfer_capacity": 262_144,
}
# The caps a forward render heals (vis_capacity is never healed: its
# default of 0 keeps every splat).
RENDER_CAPS = ("tile_capacity", "bin_capacity", "col_capacity")


def grow_caps(caps: dict, metrics: dict, max_caps: dict,
              current: Optional[Callable[[str], int]] = None) -> list[tuple[str, int]]:
    """Raise, in `caps`, every cap whose overflow fraction in `metrics` is
    nonzero: to the reported demand plus 25%, at least 1.5x the current cap,
    rounded up to 128, at most `max_caps`' ceiling. `current(kwarg)` reads
    a cap as it stands (default `caps[kwarg]`); caps are updated in
    OVERFLOW_CAP_OF's order, so a cap derived from another one reads it
    grown. Returns the (kwarg, new cap) of each cap that grew."""
    current = current or (lambda kwarg: int(caps[kwarg]))
    grown = []
    for key, kwarg in OVERFLOW_CAP_OF.items():
        v = metrics.get(key)
        if v is None or float(v) <= 0.0:
            continue
        cur = current(kwarg)
        demand = metrics.get(OVERFLOW_DEMAND_OF[key])
        want = int(float(demand) * 1.25) if demand is not None else int(cur * 1.5)
        new = min(-(-max(want, int(cur * 1.5)) // 128) * 128, max_caps[kwarg])
        if new > cur:
            caps[kwarg] = new
            grown.append((kwarg, new))
    return grown


def read_overflow(out: dict) -> dict[str, float]:
    """The render-cap overflow fractions and demands in a render's output,
    read to the host in one copy (none for the oracle)."""
    keys = [k for key, kwarg in OVERFLOW_CAP_OF.items() if kwarg in RENDER_CAPS
            for k in (key, OVERFLOW_DEMAND_OF[key]) if k in out]
    if not keys:
        return {}
    values = torch.stack([out[k].detach().reshape(()).float() for k in keys]).tolist()
    return dict(zip(keys, values))


class CapacityHealer:
    """Renders of a stored model at capacities that heal, as the Trainer's
    do: a view whose tile, bin or column lists overflow is rendered again
    at grown caps until no counter fires, or until a counter fires with its
    cap at the ceiling; that view is returned as it is and reported on
    stdout the first time each counter is cut so (a viewer renders many
    frames). More than one round can be needed: a truncated column list
    understates the bin demand, a truncated bin list the tile demand. The
    caps only grow and carry over to later views.

    `caps` (a dict holding the RENDER_CAPS keys, and any others) is updated
    in place: a caller that builds its settings from it renders at the
    caps as they stand."""

    def __init__(self, caps: dict):
        self.caps = caps
        self.views = 0       # views rendered
        self.renders = 0     # renders made, re-renders included
        self.events: list[tuple[str, str, int]] = []  # (view, kwarg, new cap)
        # counter -> (views returned with it firing at its ceiling, largest fraction)
        self.truncated: dict[str, tuple[int, float]] = {}

    @property
    def rerenders(self) -> int:
        return self.renders - self.views

    def render(self, render_at: Callable[[dict], dict], view: str = "") -> dict:
        """`render_at(caps)`'s output once no counter fires, or once every
        counter that fires has its cap at the ceiling."""
        view = view or f"view {self.views}"
        self.views += 1
        while True:
            out = render_at(self.caps)
            self.renders += 1
            metrics = read_overflow(out)
            grown = grow_caps(self.caps, metrics, MAX_CAPS)
            if not grown:
                break
            self.events += [(view, kwarg, new) for kwarg, new in grown]
            print(f"{view}: lists overflowed, rendering again at "
                  + ", ".join(f"{kwarg} {new}" for kwarg, new in grown), flush=True)
        for key, kwarg in OVERFLOW_CAP_OF.items():
            frac = metrics.get(key, 0.0)
            if frac > 0.0:
                views, most = self.truncated.get(key, (0, 0.0))
                self.truncated[key] = (views + 1, max(most, frac))
                if not views:
                    print(f"{view}: {key} {frac:.6g} with {kwarg} {self.caps[kwarg]}, not below "
                          f"its ceiling {MAX_CAPS[kwarg]}: written truncated", flush=True)
        return out
