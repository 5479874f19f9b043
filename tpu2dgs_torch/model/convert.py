"""Weights carried across between the JAX package and the port.

`from_numpy` takes the fields of a JAX `SplatParams` as numpy arrays,
under the same names (np.asarray of each leaf), and returns the port's
`SplatModel`; `to_numpy` goes the other way. Neither imports JAX: the
arrays are the interface.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from tpu2dgs_torch import default_device
from tpu2dgs_torch.model.splats import SplatModel, SplatParams


def from_numpy(params: Mapping[str, np.ndarray], live: np.ndarray,
               device=None) -> SplatModel:
    """SplatParams fields (xyz, features_dc, ...) + live mask -> SplatModel."""
    dev = default_device(device)
    missing = set(SplatParams._fields) - set(params)
    if missing:
        raise KeyError(f"missing SplatParams fields: {sorted(missing)}")

    def tensor(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

    fields = SplatParams(*(tensor(params[name], np.float32) for name in SplatParams._fields))
    return SplatModel(fields, tensor(live, np.bool_))


def to_numpy(model: SplatModel) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """SplatModel -> ({field name: array}, live mask)."""
    params = {name: getattr(model, name).detach().cpu().numpy()
              for name in SplatParams._fields}
    return params, model.live.detach().cpu().numpy()
