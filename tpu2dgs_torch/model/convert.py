"""Weights and training state carried across between the JAX package and
the port.

`from_numpy` takes the fields of a JAX `SplatParams` as numpy arrays,
under the same names (np.asarray of each leaf), and returns the port's
`SplatModel`; `to_numpy` goes the other way. `state_from_numpy` and
`state_to_numpy` carry the whole training state: the parameters, the live
mask, the densification statistics and the Adam state (count, mu, nu), as
one dictionary of numpy arrays:

    {"params": {field: array}, "live": array,
     "stats": {"max_radii2d" | "grad_accum" | "denom": array},
     "adam": {"count": int, "mu": {field: array}, "nu": {field: array}}}

Nothing here imports JAX: the arrays are the interface.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from tpu2dgs_torch import default_device
from tpu2dgs_torch.model.optim import AdamState
from tpu2dgs_torch.model.splats import STATS, SplatModel, SplatParams


def _tensor(a, dtype, dev):
    return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)


def _fields(params: Mapping[str, np.ndarray], dev) -> SplatParams:
    missing = set(SplatParams._fields) - set(params)
    if missing:
        raise KeyError(f"missing SplatParams fields: {sorted(missing)}")
    return SplatParams(*(_tensor(params[name], np.float32, dev)
                         for name in SplatParams._fields))


def _arrays(fields: SplatParams) -> dict[str, np.ndarray]:
    return {name: a.detach().cpu().numpy() for name, a in fields._asdict().items()}


def from_numpy(params: Mapping[str, np.ndarray], live: np.ndarray, device=None,
               stats: Mapping[str, np.ndarray] | None = None) -> SplatModel:
    """SplatParams fields (xyz, features_dc, ...) + live mask, and the
    densification statistics where given (else zeros) -> SplatModel."""
    dev = default_device(device)
    stats = stats or {}
    return SplatModel(_fields(params, dev), _tensor(live, np.bool_, dev),
                      *(_tensor(stats[k], np.float32, dev) if k in stats else None
                        for k in STATS))


def to_numpy(model: SplatModel) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """SplatModel -> ({field name: array}, live mask)."""
    return _arrays(model.params), model.live.detach().cpu().numpy()


def state_from_numpy(state: Mapping, device=None) -> tuple[SplatModel, AdamState]:
    """The training state dictionary (see the module docstring) ->
    (SplatModel, AdamState) on `device`."""
    dev = default_device(device)
    model = from_numpy(state["params"], state["live"], device=dev, stats=state.get("stats"))
    adam = state["adam"]
    return model, AdamState(count=int(adam["count"]), mu=_fields(adam["mu"], dev),
                            nu=_fields(adam["nu"], dev))


def state_to_numpy(model: SplatModel, adam: AdamState) -> dict:
    """(SplatModel, AdamState) -> the training state dictionary."""
    params, live = to_numpy(model)
    return {
        "params": params, "live": live,
        "stats": {k: getattr(model, k).detach().cpu().numpy() for k in STATS},
        "adam": {"count": int(adam.count), "mu": _arrays(adam.mu), "nu": _arrays(adam.nu)},
    }
